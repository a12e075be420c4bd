"""frame_ms_p95: 95th percentile of each frame's encode + decode wall
(the sides the mix times), over every frame of the window."""

from pccbench.stats import p95


def read(run):
    v = p95([r.spans.get("encode", 0.0) + r.spans["decode"] for r in run.records])
    return None if v is None else 1e3 * v
