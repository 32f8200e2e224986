"""Device busy time of the CUDA kernels launched inside the program's
kernel spans (``af.kernel.<wrapper>``), ms a traced call: the port's own
kernels, with any PyTorch kernel a wrapper launches."""

from benchmark.program_spans import kernel_ms


def read(run):
    return kernel_ms(run)
