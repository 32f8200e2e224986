"""1 - (union of the device operations' intervals) / traced window."""


def read(run):
    return None if run.trace is None else run.trace.idle_share()
