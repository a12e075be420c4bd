"""cli_geom_ms.encode: the geometry brick of tmc3-cuda's encoder
(``geom.brick`` in ``FrameEncoder._compress_slice``: the octree coding on
the device engine and the brick's header), per frame."""


def read(run):
    return run.per_frame_ms(run.span_total("encode.geom.brick"))
