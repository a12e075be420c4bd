"""cli_attr_entropy_ms.encode: the residual and zrow coder inside
tmc3-cuda's attribute bricks (the counter ``attr.entropy_s`` of
``models/attr_raht.py``), per frame; None where no frame has it."""

NAME = "encode.attr.entropy_s"


def read(run):
    if not any(NAME in r.counters for r in run.records):
        return None
    return run.per_frame_ms(run.counter_total(NAME))
