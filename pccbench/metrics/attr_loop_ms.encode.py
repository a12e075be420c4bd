"""attr_loop_ms.encode: ``DeviceFpRaht.encode`` less the harness's
``emit``, per frame (the closed loop, its copies and launches)."""


def read(run):
    loop = run.span_total("encode.attr_loop")
    if loop is None:
        return None
    return run.per_frame_ms(loop - run.counter_total("encode.emit"))
