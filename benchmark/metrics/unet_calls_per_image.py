"""Calls of the UNet's forward in the traced image (the tile plan's batches
times the steps, with CFG in one batch, plus region and inversion calls)."""


def read(rec):
    if rec.stages is None or rec.stages.unet_calls == 0:
        return None
    return float(rec.stages.unet_calls)
