"""Seconds of ``DiffusionPipeline._sample`` in the traced image (the
samplers' loop over the tiled, guided denoiser), synchronised at both
ends."""


def read(rec):
    return None if rec.stages is None else rec.stages.seconds.get("sampling")
