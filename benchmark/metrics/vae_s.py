"""Seconds of the VAE in the traced image: ``_decode_tensor``, plus
``_encode`` where the image is encoded, each synchronised at both ends."""


def read(rec):
    if rec.stages is None or "decode" not in rec.stages.seconds:
        return None
    return rec.stages.seconds["decode"] + rec.stages.seconds.get("encode", 0.0)
