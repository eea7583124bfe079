"""``max_memory_allocated`` over the decode of the traced image (reset as
the decode starts), in GiB."""


def read(rec):
    if rec.stages is None or rec.stages.decode_peak_bytes is None:
        return None
    return rec.stages.decode_peak_bytes / 2 ** 30
