"""encode_mpts: points of every frame encoded in the window over the
summed walls of the encode sides (geometry, plan, attribute loop)."""


def read(run):
    return run.side_rate("encode")
