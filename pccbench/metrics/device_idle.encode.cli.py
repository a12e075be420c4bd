"""device_idle.encode.cli: percent of tmc3-cuda's encode sides that no
device operation in the trace covers."""


def read(run):
    return run.idle_percent("encode")
