"""Seconds of the pipeline's ``get_retouch_mask`` (the guided-filter renoise
mask, numpy on the host) in the traced image; nothing where no mask is
made."""


def read(rec):
    return None if rec.stages is None else rec.stages.seconds.get("renoise_mask")
