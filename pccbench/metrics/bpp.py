"""bpp: payload bits of every stream the cell codes over its input
points, over the window."""


def read(run):
    pts = sum(r.points for r in run.records)
    return 8.0 * sum(r.payload_bytes for r in run.records) / pts \
        if pts else None
