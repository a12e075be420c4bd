"""geom_fetch_ms.geom_only: the port's ``geom.fetch`` stage of the encode
sides (``encode_pipelined``'s two-step fetch of the occupancy bytes, with
the wait for the occupancy kernel), per frame; recorded in traced runs,
where the codec installs the port's tracer."""


def read(run):
    return run.per_frame_ms(run.span_total("encode.geom.fetch"))
