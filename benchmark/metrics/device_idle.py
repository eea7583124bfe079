"""1 - (union of the intervals in which an operation ran on the device) /
(the profiled image's wall time), in %, from ``torch.profiler``'s trace."""


def read(rec):
    s = rec.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
