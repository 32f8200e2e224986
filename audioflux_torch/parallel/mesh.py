"""The device mesh of the parallel family: a ``(data, time)`` grid of
``torch.device``s.

Counterpart of ``audioflux_tpu/parallel/mesh.py``.  JAX's mesh is driven
by one program traced for every device; here one controller process walks
the grid and runs the port's single-device code once per shard (see
``parallel/sharded.py``), so a grid may name the same device more than
once: ``[torch.device("cuda:0")] * 8`` puts eight shards on one card, and
the CPU tests pass ``[torch.device("cpu")] * 8``.  Nothing picks the CPU,
or a repeated device, on the caller's behalf.

The ``data`` axis may span processes (``parallel/distributed.py``); each
process builds the mesh of its own devices.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops.backend import resolve_device

__all__ = ["Mesh", "make_mesh"]


def _norm(dev) -> torch.device:
    """``dev`` as a checked device; a CUDA device without an index gets
    the current one, so that two names of one card compare equal."""
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes.

    ``devices``: object array of ``torch.device``, one axis per name;
    ``shape``: ``{name: size}`` (the JAX code reads ``mesh.shape["time"]``).
    """

    def __init__(self, devices, axis_names=("data", "time")):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device grid for axes "
                             f"{axis_names}")
        self.devices = np.vectorize(_norm, otypes=[object])(devices)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def first(self) -> torch.device:
        """The device that assembles the global results."""
        return self.devices.flat[0]

    def grid(self, row_axis: str, col_axis: str) -> np.ndarray:
        """The devices as a (rows, cols) array over two named axes."""
        i, j = self.axis_names.index(row_axis), self.axis_names.index(col_axis)
        if i == j:
            raise ValueError(f"two different axes are needed, got {row_axis!r}")
        return np.moveaxis(self.devices, (i, j), (0, 1))

    def __repr__(self):
        names = np.vectorize(str, otypes=[object])(self.devices)
        return f"Mesh({self.shape}, devices={names.tolist()})"


def make_mesh(data: int = 1, time: int = 1, devices=None) -> Mesh:
    """A ('data', 'time') mesh over the first ``data * time`` devices.

    ``devices=None`` means the visible CUDA devices; with none it raises,
    and with too few it raises, as JAX's ``make_mesh`` does.  A list may
    repeat a device, so that every shard runs on one card (or the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=[torch.device("
                "'cpu')] * n to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = data * time
    if data < 1 or time < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} time={time}")
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(data, time), axis_names=("data", "time"))
