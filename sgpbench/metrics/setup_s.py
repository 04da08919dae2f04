"""Seconds from the process's start to the window's first timed call:
imports, the CUDA context, the inputs made from the seed and the warm-up
of the cell's own shapes (host clock)."""


def read(rec):
    return rec.get('setup_s')
