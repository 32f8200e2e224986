"""Device busy time of the operations launched inside the program's spans
and outside its kernel spans, ms a traced call: the PyTorch code the port
runs between its kernels, read from the port's own spans (what
``torch_ops_share.mir`` reckons from ``aten::`` operators)."""

from benchmark.program_spans import torch_code_ms


def read(run):
    return torch_code_ms(run)
