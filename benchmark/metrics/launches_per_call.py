"""CUDA kernels launched inside the program's spans a traced call, the
port's and PyTorch's: the work done, as a count (a fusion lowers it)."""

from benchmark.program_spans import launches_per_call


def read(run):
    return launches_per_call(run)
