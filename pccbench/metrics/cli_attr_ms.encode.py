"""cli_attr_ms.encode: the attribute brick of tmc3-cuda's encoder
(``attr.brick`` in ``FrameEncoder._compress_slice``: the colour
conversion, the RAHT with LCP and its residual coding), per frame."""


def read(run):
    return run.per_frame_ms(run.span_total("encode.attr.brick"))
