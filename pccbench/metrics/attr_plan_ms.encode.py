"""attr_plan_ms.encode: the encoder's ``DeviceFpRaht(...)``, per frame:
on a card the codes' upload and the card planner ``build_plan`` (its
kernels and one host read of the counts); on the CPU the host
``build_fp_plan`` and the plan's upload."""


def read(run):
    return run.per_frame_ms(run.span_total("encode.attr_plan"))
