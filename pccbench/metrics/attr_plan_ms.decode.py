"""attr_plan_ms.decode: the decoder's ``DeviceFpRaht(...)`` on the
decoded codes, per frame."""


def read(run):
    return run.per_frame_ms(run.span_total("decode.attr_plan"))
