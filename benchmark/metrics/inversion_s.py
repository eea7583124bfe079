"""Seconds of ``DiffusionPipeline.noise_inversion`` in the traced image,
synchronised at both ends; nothing where the cell inverts no noise."""


def read(rec):
    return None if rec.stages is None else rec.stages.seconds.get("inversion")
