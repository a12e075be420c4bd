"""device_idle.decode.cli: percent of tmc3-cuda's decode sides that no
device operation in the trace covers."""


def read(run):
    return run.idle_percent("decode")
