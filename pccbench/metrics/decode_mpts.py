"""decode_mpts: points of every frame decoded in the window over the
summed walls of the decode sides."""


def read(run):
    return run.side_rate("decode")
