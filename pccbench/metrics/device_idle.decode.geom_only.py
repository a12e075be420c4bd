"""device_idle.decode.geom_only: ``device_idle.decode`` in the
geometry-only cells, where it moves ``frame_ms_p95``: percent of the
decode sides that no device operation in the trace covers."""


def read(run):
    return run.idle_percent("decode")
