"""Device busy time of the operations launched inside the program's spans
and outside its kernel spans, ms a traced call: the PyTorch code of the
four pitch estimators around their kernels (HPS's complex, magnitude,
harmonic gather and product; PEF's power, log-grid gathers and spectrum
product; HarmonicRatio's cumsum tail and searches; the frames' window
products and copies)."""

from benchmark.program_spans import torch_code_ms


def read(run):
    return torch_code_ms(run)
