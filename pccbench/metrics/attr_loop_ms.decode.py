"""attr_loop_ms.decode: ``DeviceFpRaht.decode`` and the values' fetch,
less the harness's ``read_q``, per frame."""


def read(run):
    loop = run.span_total("decode.attr_loop")
    if loop is None:
        return None
    return run.per_frame_ms(loop - run.counter_total("decode.read_q"))
