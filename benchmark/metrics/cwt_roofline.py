"""The bound of the CWT step's need (``counts/<config>.py`` ``cwt_need``:
the forward transform, the bank's inverses, x, W and the bank moved once)
over the device busy time launched inside the traced calls' ``cwt`` span,
in percent."""

from benchmark.readers import roofline_pct


def read(run):
    rows, n = ((1,) + run.request_shape)[-2:]
    return roofline_pct(run, "cwt", run.counts().cwt_need(run.cfg, rows, n))
