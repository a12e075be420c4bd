"""geom_decode_ms.geom_only: ``geom_decode_ms`` in the geometry-only
cells, where it moves ``frame_ms_p95``: ``decode_pipelined`` and the
leaf codes' fetch, per frame (runtime/device_pipeline)."""


def read(run):
    return run.per_frame_ms(run.span_total("decode.geom"))
