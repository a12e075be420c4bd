"""setup_s: process start to the window's start: imports, the kernels'
and the native library's load (their build in a checkout's first run),
the frames made from the seed, and one untimed frame."""


def read(run):
    return run.setup_s
