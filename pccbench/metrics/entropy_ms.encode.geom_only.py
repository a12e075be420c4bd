"""entropy_ms.encode.geom_only: ``entropy_ms.encode`` in the
geometry-only cells, where it moves ``frame_ms_p95``: the host range
coders of an encode, per frame: ``PipelineStats.host_entropy_s`` plus
the harness's zrow ``emit``."""


def read(run):
    return run.per_frame_ms(run.counter_total("encode.geom_entropy")
                            + run.counter_total("encode.emit"))
