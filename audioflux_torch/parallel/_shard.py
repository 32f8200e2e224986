"""Shard, run, assemble: the helpers every sharded function shares.

One controller walks the mesh.  A sharded function splits its input along
the mesh axes, places each block on its device (:func:`place`), copies the
halos it needs from a neighbour's block to its own device, runs the port's
single-device code there (under :func:`on`, so that a kernel launches on
that device's current stream), and assembles the global result on the
mesh's first device (:func:`gather`).  On a device that the mesh names
more than once, ``Tensor.to`` returns the block itself, so no step writes
into a block or a halo in place.
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

__all__ = ["on", "place", "gather", "Assembler", "replica", "check_2d",
           "tree_gather", "MODES", "check_mode"]

MODES = ("auto", "gspmd", "shard_map")


def check_mode(mode: str) -> None:
    """Every mode runs the same explicit per-shard form; the argument is
    kept, and checked, so that callers of the JAX package's signatures
    keep working."""
    if mode not in MODES:
        raise ValueError(f"mode must be auto/gspmd/shard_map, got {mode!r}")


def on(dev: torch.device):
    """Make ``dev`` the current CUDA device (a no-op on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def place(x, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (host data or a tensor on any device) as ``dtype`` on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        device=dev, dtype=dtype)


def gather(parts, dim: int, dev: torch.device) -> torch.Tensor:
    """Concatenate ``parts`` in order along ``dim`` on ``dev``."""
    parts = [p.to(dev, non_blocking=True) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


class Assembler:
    """A global result on one device, each shard's part copied once into
    its place (no concatenation of concatenations).  The buffer is made
    when the first part arrives: ``shape`` is the global shape and
    ``index`` the part's place in it."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.out = None

    def put(self, part: torch.Tensor, index, shape) -> None:
        if self.out is None:
            self.out = torch.empty(shape, dtype=part.dtype, device=self.dev)
        self.out[index].copy_(part, non_blocking=True)


def tree_gather(trees, dim: int, dev: torch.device):
    """Concatenate the matching tensors of several nests along ``dim``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_gather([t[k] for t in trees], dim, dev)
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_gather([t[i] for t in trees], dim, dev)
                           for i in range(len(first)))
    return gather(trees, dim, dev)


def check_2d(x, n_rows: int, n_cols: int, what: str):
    """A (B, n) input whose batch divides ``n_rows`` and whose length
    divides ``n_cols`` (1: any length)."""
    shape = tuple(x.shape)
    if len(shape) != 2:
        raise ValueError(f"{what} expects (B, n) input, got {shape}")
    if shape[0] % n_rows:
        raise ValueError(f"batch {shape[0]} must divide the batch mesh "
                         f"axis ({n_rows})")
    if shape[1] % n_cols:
        raise ValueError(f"{what}: length {shape[1]} must divide the time "
                         f"mesh axis ({n_cols})")
    return shape


def replica(plan, dev: torch.device):
    """The plan with its device constants on ``dev``: the plan itself when
    it lives there, else a copy that re-uploads them (cached on the plan).
    Plans nested in the plan (a WSST's CWT, a CQT's resampler) follow."""
    if _same(plan.device, dev):
        return plan
    cache = plan.__dict__.setdefault("_replicas", {})
    rep = cache.get(str(dev))
    if rep is None:
        rep = copy.copy(plan)
        rep.__dict__ = {k: v for k, v in plan.__dict__.items()
                        if k != "_replicas"}
        rep.device = dev
        for k, v in list(rep.__dict__.items()):
            if isinstance(getattr(v, "device", None), torch.device) \
                    and hasattr(v, "__dict__") and not isinstance(
                        v, torch.Tensor):
                rep.__dict__[k] = replica(v, dev)
        if hasattr(rep, "_build_exec"):
            rep._build_exec()
        cache[str(dev)] = rep
    return rep


def _same(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type == "cpu":
        return True
    cur = torch.cuda.current_device
    return (a.index if a.index is not None else cur()) == (
        b.index if b.index is not None else cur())
