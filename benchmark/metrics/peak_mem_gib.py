"""``torch.cuda.max_memory_allocated()`` over the window (reset at its start),
in GiB: what decides whether an image fits."""


def read(rec):
    return None if rec.peak_bytes is None else rec.peak_bytes / 2 ** 30
