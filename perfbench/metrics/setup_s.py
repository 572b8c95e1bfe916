"""setup_s: seconds from the process's start to the window's first step
or batch (imports, the kernels' load or build, the weights' draw, the
state, the carousel, the warm-up)."""


def read(rec):
    return rec.setup_s
