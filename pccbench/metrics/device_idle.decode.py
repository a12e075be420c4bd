"""device_idle.decode: percent of the decode sides that no device
operation in the trace covers."""


def read(run):
    return run.idle_percent("decode")
