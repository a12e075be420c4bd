"""cli_attr_quant_ms.encode: the host quantiser inside tmc3-cuda's
attribute bricks (span ``attr.quant`` of ``models/attr_raht.py``: RDOQ,
the deadzone quantiser, the LCP estimate and the zrow coder, a layer a
call), per frame; None where no frame has the span (a port without
it)."""


def read(run):
    return run.per_frame_ms(run.span_total("encode.attr.quant"))
