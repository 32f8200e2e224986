"""The bound of the HPSS stage's need (``counts/<config>.py``
``hpss_need``: its transforms and its bytes; the medians are not counted,
so this is a lower bound) over the device busy time launched inside the
traced calls' ``hpss`` span, in percent."""

from benchmark.readers import roofline_pct


def read(run):
    rows, n = ((1,) + run.request_shape)[-2:]
    return roofline_pct(run, "hpss", run.counts().hpss_need(run.cfg, rows, n))
