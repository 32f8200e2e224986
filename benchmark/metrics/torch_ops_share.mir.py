"""Share of the device time of the traced calls that ran operations
launched under an ``aten::`` operator (PyTorch code between the program's
own kernels, which are launched through ctypes outside any operator)."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    ops = tr.launched_in("bench.call")
    total = sum(e - s for s, e, *_ in ops)
    if total <= 0:
        return None
    return sum(op[1] - op[0] for op in ops if tr.under_aten(op)) / total
