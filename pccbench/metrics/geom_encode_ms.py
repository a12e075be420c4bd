"""geom_encode_ms: the codes' upload, ``encode_pipelined`` and
``get_bytes``, per frame (runtime/device_pipeline)."""


def read(run):
    return run.per_frame_ms(run.span_total("encode.geom"))
