"""Sharded global statistics of a spectrogram whose frames are split over
the ``time`` mesh axis.

Counterpart of ``audioflux_tpu/parallel/features.py``: where JAX reduces
with ``psum``/``pmax`` across the time shards, each shard here reduces its
own frames on its device, and the partial sums are added in shard order
on the mesh's first device (the default: one (B, num) tensor a statistic)
or, with ``keep_sharded=True``, on the first device of each data row (a
``ShardedTensor`` a statistic, ``P(batch, None)``: JAX's out spec, the
value held once a row where JAX replicates it over ``time``).  A
``ShardedTensor`` input (``sharded_spectrogram_fn(..., keep_sharded=True)``)
is reduced part by part where it lies: only the (B, num) partials move.
"""

from __future__ import annotations

import torch

from audioflux_torch.ops.backend import f32_scalar
from audioflux_torch.parallel._shard import (ShardedTensor, Shards, on, place,
                                             position, sharded_input)
from audioflux_torch.parallel.mesh import Mesh

__all__ = ["sharded_spectral_stats_fn"]


def _row_parts(S: ShardedTensor, n_b: int):
    """Per data row, its shards in time order, checked to cover the row's
    frames exactly once."""
    B, _, T = S.shape
    b = B // n_b
    rows = [[] for _ in range(n_b)]
    for s in S.shards:
        r0, r1 = s.index[0].indices(B)[:2]
        t0, t1 = s.index[2].indices(T)[:2]
        if r1 - r0 != b or r0 % b or s.index[1] != slice(None):
            raise ValueError(f"spectral stats: a shard holds rows "
                             f"[{r0}, {r1}) and {s.index[1]}; the data axis "
                             f"splits {B} rows {b} a shard")
        rows[r0 // b].append((t0, t1, s))
    for i, row in enumerate(rows):
        row.sort(key=lambda p: p[0])
        if not row or row[-1][1] != T or \
                [p[0] for p in row] != [0] + [p[1] for p in row[:-1]]:
            raise ValueError(f"spectral stats: data row {i}'s shards do not "
                             f"cover the {T} frames once")
    return rows


def sharded_spectral_stats_fn(mesh: Mesh, batch_axis: str = "data",
                              time_axis: str = "time",
                              keep_sharded: bool = False):
    """A reducer over a (B, num, T) spectrogram, B split over ``data`` and T
    over ``time`` (each must divide its axis): returns ``{'sum', 'mean',
    'max', 'var'}``, each (B, num) on the mesh's first device, equal to the
    unsharded reductions up to the order of the sums.  A ``ShardedTensor``
    input ``P(batch, None, time)`` may split T in any parts (the kept
    spectrogram's last part is shorter)."""

    def run(S):
        S = sharded_input(S, mesh, (batch_axis, None, time_axis),
                          "spectral stats")
        grid = mesh.grid(batch_axis, time_axis)
        n_b, n_t = grid.shape
        kept = isinstance(S, ShardedTensor)
        if S.ndim != 3 or S.shape[0] % n_b or (
                not kept and S.shape[-1] % n_t):
            raise ValueError(f"spectral stats need (B, num, T) with B % "
                             f"{n_b} == 0 and T % {n_t} == 0, got "
                             f"{tuple(S.shape)}")
        B, _, T = S.shape
        b_loc, t_loc = B // n_b, T // n_t
        if kept:
            parts_of = _row_parts(S, n_b)

            def blocks(i):
                for _, _, s in parts_of[i]:
                    yield s.device, s.data
        else:
            def blocks(i):
                for j in range(n_t):
                    dev = grid[i, j]
                    yield dev, place(S[i * b_loc:(i + 1) * b_loc, :,
                                       j * t_loc:(j + 1) * t_loc], dev)
        out = {"sum": [], "max": [], "sq": []}
        for i in range(n_b):
            home = grid[i, 0] if keep_sharded else mesh.first
            s = mx = sq = None
            for dev, blk in blocks(i):
                with on(dev):
                    parts = (blk.sum(-1), blk.amax(-1), (blk * blk).sum(-1))
                parts = [p.to(home, non_blocking=True) for p in parts]
                if s is None:
                    s, mx, sq = parts
                else:
                    s = s + parts[0]
                    mx = torch.maximum(mx, parts[1])
                    sq = sq + parts[2]
            out["sum"].append(s)
            out["max"].append(mx)
            out["sq"].append(sq)
        if keep_sharded:
            res = {k: Shards(mesh, (batch_axis, None))
                   for k in ("sum", "mean", "max", "var")}
            for i in range(n_b):
                s, mx, sq = (out[k][i] for k in ("sum", "max", "sq"))
                mean = s / f32_scalar(T, s.device)
                vals = {"sum": s, "mean": mean, "max": mx,
                        "var": sq / f32_scalar(T, s.device) - mean * mean}
                pos = position(mesh, **{batch_axis: i})
                for k, v in vals.items():
                    res[k].put(v, (slice(i * b_loc, (i + 1) * b_loc),),
                               (B,) + tuple(v.shape[1:]), pos)
            return {k: r.out for k, r in res.items()}
        s, mx, sq = (torch.cat(out[k]) for k in ("sum", "max", "sq"))
        mean = s / f32_scalar(T, s.device)
        return {"sum": s, "mean": mean, "max": mx, "var": sq / f32_scalar(T, s.device) - mean * mean}

    return run
