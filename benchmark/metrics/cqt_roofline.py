"""The bound of the CQT's need (``counts/<config>.py`` ``cqt_need``: the
audio, each resampled level and the output moved once; the octaves'
transforms, the kernel product over the bank's nonzeros and the
resampler's taps; bound by its operations at the cell's size) over the
device busy time launched inside the traced calls' ``cqt`` span, in
percent."""

from benchmark.readers import roofline_pct


def read(run):
    rows, n = ((1,) + run.request_shape)[-2:]
    return roofline_pct(run, "cqt", run.counts().cqt_need(run.cfg, rows, n))
