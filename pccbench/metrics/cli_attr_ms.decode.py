"""cli_attr_ms.decode: the attribute brick of tmc3-cuda's decoder
(``attr.brick`` around ``FrameDecoder._decode_attribute_brick``), per
frame."""


def read(run):
    return run.per_frame_ms(run.span_total("decode.attr.brick"))
