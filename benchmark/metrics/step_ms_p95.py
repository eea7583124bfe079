"""95th percentile of the sampler steps of the counted images, each timed
between CUDA events recorded by the step callback (an image's first step
from an event recorded as the image starts), in ms."""
from benchmark.harness.stats import percentile


def read(rec):
    return percentile(rec.step_ms, 95) if len(rec.step_ms) >= 20 else None
