"""The bound of the call's mel+MFCC work (``counts/<config>.py``) over the
device busy time of what the traced calls launched, in percent."""

from benchmark.readers import roofline_pct


def read(run):
    clips, n = ((1,) + run.request_shape)[-2:]
    return roofline_pct(run, "call", run.counts().need(run.cfg, clips, n))
