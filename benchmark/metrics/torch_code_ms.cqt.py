"""Device busy time of the operations launched inside the program's spans
and outside its kernel spans, ms a traced call: in the CQT cell all of
the call's device work, which runs no hand-written kernel (the
resampler's padding, unfold copies and products, the octaves' frame
copies and library transforms, the four kernel products, the cat, scale
and transpose, the chroma's power, fold and normalisation)."""

from benchmark.program_spans import torch_code_ms


def read(run):
    return torch_code_ms(run)
