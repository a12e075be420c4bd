"""geom_count_ms.geom_only: the port's ``geom.count`` stage of the decode
sides (``decode_pipelined``'s level counting from the decoded occupancy
bytes: ``popcount8_np`` and the level loop), per frame; recorded in
traced runs, where the codec installs the port's tracer."""


def read(run):
    return run.per_frame_ms(run.span_total("decode.geom.count"))
