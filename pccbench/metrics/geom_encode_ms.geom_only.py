"""geom_encode_ms.geom_only: ``geom_encode_ms`` in the geometry-only
cells, where it moves ``frame_ms_p95``: the codes' upload,
``encode_pipelined`` and ``get_bytes``, per frame
(runtime/device_pipeline)."""


def read(run):
    return run.per_frame_ms(run.span_total("encode.geom"))
