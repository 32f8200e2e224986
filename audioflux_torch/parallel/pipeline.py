"""Pipeline parallelism: stage an op chain across the devices of a mesh
axis.

Counterpart of ``audioflux_tpu/parallel/pipeline.py``.  Stage ``k`` of the
chain lives on device ``k`` of the pipe axis (the other axis at index 0),
the batch is split into microbatches, and the ``n_micro + n_stage - 1``
ticks of the GPipe schedule are a host loop: at tick ``t`` stage ``k``
runs microbatch ``t - k`` and its output is copied to stage ``k + 1``'s
device (``Tensor.to``, which orders the copy after the producing stream's
work).  Each stage holds only its own constants.

Not ported, by design: the fixed-size float32 carrier buffer that every
activation was flattened into and out of, and the ``lax.switch`` over
stage bodies; both exist because SPMD traces one program for every
device.  Activations here travel at their own shapes, as float32.
"""

from __future__ import annotations

import torch

from audioflux_torch.parallel._shard import on, place
from audioflux_torch.parallel.mesh import Mesh

__all__ = ["pipeline_chain_fn"]


def pipeline_chain_fn(stage_fns, stage_shapes, mesh: Mesh,
                      axis: str = "time", n_micro: int = None):
    """A pipelined executor for a chain of per-microbatch stages.

    stage_fns: S functions; stage ``k`` maps ``(mb,) + stage_shapes[k]`` to
        ``(mb,) + stage_shapes[k + 1]`` (float32 in and out) on its device.
    stage_shapes: S + 1 per-example shapes, the chain's input first.
    mesh, axis: the pipe axis; its size must equal S.
    n_micro: the number of microbatches (default: S).

    Returns ``run(x)`` taking ``(batch,) + stage_shapes[0]``, ``batch``
    divisible by ``n_micro``, and returning ``(batch,) +
    stage_shapes[-1]`` on the mesh's first device, equal to composing the
    stages directly on each microbatch."""
    n_stage = len(stage_fns)
    if mesh.shape[axis] != n_stage:
        raise ValueError(f"mesh axis '{axis}' has {mesh.shape[axis]} "
                         f"devices, chain has {n_stage} stages")
    if len(stage_shapes) != n_stage + 1:
        raise ValueError("need len(stage_fns)+1 stage_shapes")
    if n_micro is None:
        n_micro = n_stage
    other = next(a for a in mesh.axis_names if a != axis)
    devs = list(mesh.grid(axis, other)[:, 0])
    shapes = [tuple(s) for s in stage_shapes]

    def run(x):
        x = place(x, devs[0])
        batch = x.shape[0]
        if batch % n_micro:
            raise ValueError(f"batch {batch} not divisible by {n_micro}")
        if tuple(x.shape[1:]) != shapes[0]:
            raise ValueError(f"input shape {tuple(x.shape[1:])} != "
                             f"{shapes[0]}")
        xs = x.split(batch // n_micro)
        outs = [None] * n_micro
        held = [None] * n_stage     # the input each stage takes next tick
        for t in range(n_micro + n_stage - 1):
            nxt = [None] * n_stage
            for k in range(n_stage):
                m = t - k
                if not 0 <= m < n_micro:
                    continue
                inp = xs[m] if k == 0 else held[k]
                with on(devs[k]):
                    y = stage_fns[k](inp).to(torch.float32)
                if tuple(y.shape[1:]) != shapes[k + 1]:
                    raise ValueError(f"stage {k} gave {tuple(y.shape[1:])}, "
                                     f"expected {shapes[k + 1]}")
                if k == n_stage - 1:
                    outs[m] = y.to(mesh.first, non_blocking=True)
                else:
                    nxt[k + 1] = y.to(devs[k + 1], non_blocking=True)
            held = nxt
        return torch.cat(outs)

    return run
