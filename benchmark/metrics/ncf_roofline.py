"""The bound of NCF's need (``counts/<config>.py`` ``ncf_need``: its
forward at 2 N and its inverse to the lags read, as pruned real
transforms; the audio read and the track written once; the gathers,
products and searches not counted, so this is a lower bound) over the
device busy time launched inside the traced calls' ``ncf`` span, in
percent."""

from benchmark.readers import roofline_pct


def read(run):
    rows, n = ((1,) + run.request_shape)[-2:]
    return roofline_pct(run, "ncf", run.counts().ncf_need(run.cfg, rows, n))
