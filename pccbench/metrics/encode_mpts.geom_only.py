"""encode_mpts.geom_only: ``encode_mpts`` of the geometry-only cells,
where the host's drift from run to run is too wide for an end-to-end
bound: points of every frame encoded in the window over the summed
walls of the encode sides."""


def read(run):
    return run.side_rate("encode")
