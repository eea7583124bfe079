"""Seconds from the process's start to the window's start: imports, weights
drawn on the card, the program built, the warm image (and, in a fresh
checkout, the kernels' build)."""


def read(rec):
    return rec.setup_s
