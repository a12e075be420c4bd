"""geom_decode_ms: ``decode_pipelined`` and the leaf codes' fetch, per
frame (runtime/device_pipeline)."""


def read(run):
    return run.per_frame_ms(run.span_total("decode.geom"))
