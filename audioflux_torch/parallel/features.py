"""Sharded global statistics of a spectrogram whose frames are split over
the ``time`` mesh axis.

Counterpart of ``audioflux_tpu/parallel/features.py``: where JAX reduces
with ``psum``/``pmax`` across the time shards, each shard here reduces its
own frames on its device, and the partial sums are added on the mesh's
first device in shard order.
"""

from __future__ import annotations

import torch

from audioflux_torch.ops.backend import f32_scalar
from audioflux_torch.parallel._shard import on, place
from audioflux_torch.parallel.mesh import Mesh

__all__ = ["sharded_spectral_stats_fn"]


def sharded_spectral_stats_fn(mesh: Mesh, batch_axis: str = "data",
                              time_axis: str = "time"):
    """A reducer over a (B, num, T) spectrogram, B split over ``data`` and T
    over ``time`` (each must divide its axis): returns ``{'sum', 'mean',
    'max', 'var'}``, each (B, num) on the mesh's first device, equal to the
    unsharded reductions up to the order of the sums."""

    def run(S):
        grid = mesh.grid(batch_axis, time_axis)
        n_b, n_t = grid.shape
        if S.ndim != 3 or S.shape[0] % n_b or S.shape[-1] % n_t:
            raise ValueError(f"spectral stats need (B, num, T) with B % "
                             f"{n_b} == 0 and T % {n_t} == 0, got "
                             f"{tuple(S.shape)}")
        B, _, T = S.shape
        b_loc, t_loc = B // n_b, T // n_t
        out = {"sum": [], "max": [], "sq": []}
        for i in range(n_b):
            s = mx = sq = None
            for j in range(n_t):
                dev = grid[i, j]
                blk = place(S[i * b_loc:(i + 1) * b_loc, :,
                              j * t_loc:(j + 1) * t_loc], dev)
                with on(dev):
                    parts = (blk.sum(-1), blk.amax(-1), (blk * blk).sum(-1))
                parts = [p.to(mesh.first, non_blocking=True) for p in parts]
                if s is None:
                    s, mx, sq = parts
                else:
                    s = s + parts[0]
                    mx = torch.maximum(mx, parts[1])
                    sq = sq + parts[2]
            out["sum"].append(s)
            out["max"].append(mx)
            out["sq"].append(sq)
        s, mx, sq = (torch.cat(out[k]) for k in ("sum", "max", "sq"))
        mean = s / f32_scalar(T, s.device)
        return {"sum": s, "mean": mean, "max": mx, "var": sq / f32_scalar(T, s.device) - mean * mean}

    return run
