"""geom_redo_ms.geom_only: the port's ``geom.redo`` stage of the encode
sides (``encode_pipelined``'s overflow branch: a second occupancy pass
with room to spare and its unbucketed fetch), per frame.  A frame whose
bytes fit its budget takes no redo and adds nothing; the metric is read
wherever the tracer recorded the fetch, the stage every encode passes."""


def read(run):
    if run.span_total("encode.geom.fetch") is None:
        return None
    return run.per_frame_ms(run.span_total("encode.geom.redo") or 0.0)
