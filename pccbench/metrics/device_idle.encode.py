"""device_idle.encode: percent of the encode sides that no device
operation in the trace covers."""


def read(run):
    return run.idle_percent("encode")
