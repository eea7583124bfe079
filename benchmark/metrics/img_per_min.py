"""Images completed in the window over the window's time, per minute: the
window runs from the first timed image's start to the last counted image's
end; an image in flight when the time is up is not counted."""
from benchmark.harness.stats import rate_per_min


def read(rec):
    return rate_per_min(rec.images_ok, rec.window_s)
