"""attr_plan_ms.decode: the decoder's ``DeviceFpRaht(...)`` on the
decoded codes, per frame: on a card the codes' upload and the card
planner ``build_plan``; on the CPU the host ``build_fp_plan`` and the
plan's upload."""


def read(run):
    return run.per_frame_ms(run.span_total("decode.attr_plan"))
