"""entropy_ms.encode: the host range coders of an encode, per frame:
``PipelineStats.host_entropy_s`` plus the harness's zrow ``emit``."""


def read(run):
    return run.per_frame_ms(run.counter_total("encode.geom_entropy")
                            + run.counter_total("encode.emit"))
