"""cli_prepare_ms.encode: ``FrameEncoder._prepare_frame`` (axis order,
input quantisation, merging duplicates), tmc3-cuda's ``frame.prepare``
span, per frame."""


def read(run):
    return run.per_frame_ms(run.span_total("encode.frame.prepare"))
