"""device_idle.encode.geom_only: ``device_idle.encode`` in the
geometry-only cells, where it moves ``frame_ms_p95``: percent of the
encode sides that no device operation in the trace covers."""


def read(run):
    return run.idle_percent("encode")
