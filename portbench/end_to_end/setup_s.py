"""Seconds from the start of the benchmark's process to the first timed
step: imports, the grid and static context, the kernel library's load (and
build, in a checkout's first run), the initial state and the warm-up."""


def read(rec):
    return rec.setup_s
