"""Model operations of the images completed in the window over the window's
seconds times 989 TFLOP/s (dense bf16), in %. The operations are counted
from the benchmark's plan and plain modules (``harness/flops.py``); the
window's images run with no span and no profiler."""
from benchmark.harness.flops import PEAK_BF16_FLOPS


def read(rec):
    if rec.images_ok <= 0 or rec.window_s <= 0 or rec.image_flops <= 0:
        return None
    return 100.0 * rec.image_flops * rec.images_ok / rec.window_s / PEAK_BF16_FLOPS
