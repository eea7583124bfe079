"""Share of its roofline that attention reaches in the profiled image, in %:
over every call of ``multi_head_attention``, the sum of least times
(max(4 B H Lq Lk D / 989 TFLOP/s, q, k, v and o bytes once / 3.35 TB/s))
over the sum of the device time of the kernels launched inside the call's
range. The work is counted from the call's shapes, whatever implements it."""


def read(rec):
    t = rec.attn_totals()
    return None if t is None else 100.0 * t[0] / t[1]
