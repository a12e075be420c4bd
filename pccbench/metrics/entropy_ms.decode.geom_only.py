"""entropy_ms.decode.geom_only: ``entropy_ms.decode`` in the
geometry-only cells, where it moves ``frame_ms_p95``: the host range
decoders, per frame: ``decode_pipelined``'s ``host_entropy_s`` plus
the harness's ``read_q``."""


def read(run):
    return run.per_frame_ms(run.counter_total("decode.geom_entropy")
                            + run.counter_total("decode.read_q"))
