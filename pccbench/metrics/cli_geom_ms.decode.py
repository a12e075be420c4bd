"""cli_geom_ms.decode: the geometry brick of tmc3-cuda's decoder
(``geom.brick`` around ``FrameDecoder._decode_geometry_brick``), per
frame."""


def read(run):
    return run.per_frame_ms(run.span_total("decode.geom.brick"))
