"""Device busy time of the operations launched inside the program's spans
and outside its kernel spans, ms a traced call: the PyTorch code of
``CWT.cwt`` and ``Synsq.synsq`` around their kernels (the padding's
copies, the forward ``torch.fft`` of the padded clips, any copy to a
contiguous layout)."""

from benchmark.program_spans import torch_code_ms


def read(run):
    return torch_code_ms(run)
