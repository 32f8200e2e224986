"""The bound of HPS's need (``counts/<config>.py`` ``hps_need``: its
forward at X, as pruned real transforms; the audio read and the track
written once; the gathers, products and searches not counted, so this is
a lower bound) over the device busy time launched inside the traced
calls' ``hps`` span, in percent."""

from benchmark.readers import roofline_pct


def read(run):
    rows, n = ((1,) + run.request_shape)[-2:]
    return roofline_pct(run, "hps", run.counts().hps_need(run.cfg, rows, n))
