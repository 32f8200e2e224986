"""The bound of the squeeze's need (``counts/<config>.py`` ``synsq_need``:
W read and S written once; its operations are not counted, so this is a
lower bound) over the device busy time launched inside the traced calls'
``synsq`` span, in percent."""

from benchmark.readers import roofline_pct


def read(run):
    rows, n = ((1,) + run.request_shape)[-2:]
    return roofline_pct(run, "synsq",
                        run.counts().synsq_need(run.cfg, rows, n))
