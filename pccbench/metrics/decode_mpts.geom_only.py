"""decode_mpts.geom_only: ``decode_mpts`` of the geometry-only cells (see
``encode_mpts.geom_only``): points of every frame decoded in the
window over the summed walls of the decode sides."""


def read(run):
    return run.side_rate("decode")
