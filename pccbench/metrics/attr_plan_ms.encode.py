"""attr_plan_ms.encode: the encoder's ``DeviceFpRaht(...)`` (host
planner ``build_fp_plan`` and the plan's staging), per frame."""


def read(run):
    return run.per_frame_ms(run.span_total("encode.attr_plan"))
