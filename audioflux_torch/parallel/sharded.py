"""Sharded STFT-family transforms: frame-block sequence parallelism with a
halo exchange.

Counterpart of ``audioflux_tpu/parallel/sharded.py``.  A long recording is
split along time into equal blocks, one per device of the ``time`` mesh
axis, and its batch along the ``data`` axis.  STFT frames that start inside
a block need ``fft - slide`` samples of the right neighbour's block: the
tail the reference's streaming ``isContinue`` mode carries across chunks
(``stft_algorithm.c:474-600``).  Here one controller copies that halo to
the block's device (``Tensor.to``; on a device the mesh names twice it is
the block itself, read and never written), runs the port's single-device
code on ``block ‖ halo`` there, so that every kernel launches once per
shard at the shard's shape, and assembles the global result on the mesh's
first device; with ``keep_sharded=True`` it returns a ``ShardedTensor``
laid out by the JAX function's ``out_specs`` instead, each part on the
device that computed it.  Each function also takes a ``ShardedTensor``
laid out by its JAX ``in_specs``: a time shard then reads its own block
where it lies and copies only the halo from its neighbour (JAX's
``ppermute``), so the STFT feeds the ISTFT, and the spectrogram the
spectral statistics (``parallel/features.py``), with no gather.

Frame-count convention: each block of L samples (L a multiple of
``slide``) computes ``L // slide`` frame slots, and the functions return
the trimmed global result, exactly ``valid_frames(n, fft, slide)`` frames,
as the unsharded transform does.  The last shard's halo wraps to shard 0's
head; its final ``fft // slide - 1`` slots are zero-masked before the
trim, so that no intermediate holds wrap-around data.  JAX's trim hands
back a result replicated over ``time`` (``P(data)``, read from
``out.sharding`` on an 8-device CPU mesh) rather than its ``out_specs``;
a kept result follows the ``out_specs``, and its last time part holds
only the valid frames (or samples, for the ISTFT: a part past the last
one holds nothing and is left out).

The ISTFT is the adjoint: the frames are zero-padded to a whole number of
equal shards, padded slots are masked out of the overlap-add and of the
window-energy normalisation, each block's ``fft - slide`` spill is added
to the head of the block on its right (zero into shard 0), and the output
is trimmed to ``(T - 1) * slide + fft`` samples.

Not ported, by design: ``_pin_native_fft`` / ``native_fft_scope`` (GSPMD
may replicate an opaque ``pallas_call``; an explicit shard runs its own
kernels), ``check_vma``, and the ``fused_tile`` / ``fused_interpret``
arguments (a TPU kernel's tile and interpret mode; accepted and unused).
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.fused_mel import FusedMelPlan, fused_mel_mfcc
from audioflux_torch.parallel._shard import (ShardedTensor, check_2d, on,
                                             place, position, replica,
                                             row_source, sharded_input, sink)
from audioflux_torch.parallel.mesh import Mesh
from audioflux_torch.transforms.spectrogram import xxcc_from_spec
from audioflux_torch.transforms.stft import _overlap_add, _stft_impl

__all__ = ["sharded_spectrogram_fn", "sharded_stft_fn", "sharded_istft_fn",
           "valid_frames"]


def valid_frames(n_samples: int, fft_length: int, slide_length: int) -> int:
    """Frames of the sharded output that match the unsharded transform."""
    return (n_samples - fft_length) // slide_length + 1


def _frame_mask(arr: torch.Tensor, start: int, t_valid: int,
                dim: int) -> torch.Tensor:
    """``arr`` with its frame slots at or past ``t_valid`` (global index
    ``start + k`` along ``dim``) set to zero."""
    t_loc = arr.shape[dim]
    keep = t_valid - start
    if keep >= t_loc:
        return arr
    idx = torch.arange(t_loc, device=arr.device)
    shape = [1] * arr.ndim
    shape[dim] = t_loc
    return torch.where((idx < keep).reshape(shape), arr,
                       torch.zeros((), dtype=arr.dtype, device=arr.device))


def _time_blocks(x, mesh: Mesh, batch_axis: str, time_axis: str,
                 slide: int, halo: int, what: str):
    """Check a (B, n) input against the mesh and return ``(n, shards)``:
    ``shards`` yields ``(i, j, dev, block ‖ halo)``, data shard by data
    shard, each block on its device.  The block and its halo are copied
    into one buffer (the kernels read contiguous rows) when the shard's
    turn comes, so one such buffer a device exists at a time.  A
    ``ShardedTensor`` input (``P(batch, time)``) gives each block where it
    lies; the halo comes from the neighbour's part."""
    x = sharded_input(x, mesh, (batch_axis, time_axis), what)
    grid = mesh.grid(batch_axis, time_axis)
    n_b, n_t = grid.shape
    B, n = check_2d(x, n_b, n_t, what)
    n_loc = n // n_t
    if n_loc % slide:
        raise ValueError(f"{what}: per-shard length {n_loc} must be a "
                         f"multiple of slide_length {slide}")
    if n_loc < halo:
        raise ValueError(f"{what}: per-shard length {n_loc} is shorter "
                         f"than the halo fft - slide = {halo}")
    if valid_frames(n, slide + halo, slide) < 1:
        raise ValueError(f"{what}: {n} samples hold no frame of "
                         f"{slide + halo}")
    rows_on = row_source(x, n_b)[1]

    def shards():
        for i in range(n_b):
            blocks = [rows_on(i, grid[i, j], slice(j * n_loc, (j + 1) * n_loc))
                      for j in range(n_t)]
            for j in range(n_t):
                dev = grid[i, j]
                right = blocks[(j + 1) % n_t][:, :halo].to(
                    dev, non_blocking=True)
                yield i, j, dev, torch.cat([blocks[j], right], dim=-1)
    return n, shards()


def _put_frames(out, part, i: int, n_b: int, start: int, t_valid: int,
                dim: int, pos=None):
    """Hand data shard ``i``'s (of ``n_b``) frame slots below ``t_valid`` to
    the sink ``out`` (frames along ``dim``, -1 or -2; ``pos`` the shard's
    mesh position)."""
    keep = min(part.shape[dim], t_valid - start)
    if keep <= 0:
        return
    b_loc = part.shape[0]
    shape = list(part.shape)
    shape[0] = b_loc * n_b
    shape[dim] = t_valid
    index = [slice(None)] * part.ndim
    index[0] = slice(i * b_loc, (i + 1) * b_loc)
    index[dim] = slice(start, start + keep)
    src = [slice(None)] * part.ndim
    src[dim] = slice(0, keep)
    out.put(part[tuple(src)], tuple(index), shape, pos)


def sharded_stft_fn(mesh: Mesh, fft_length: int, slide_length: int, window,
                    batch_axis: str = "data", time_axis: str = "time",
                    keep_sharded: bool = False):
    """A sharded STFT: (B, n) -> complex64 (B, T_valid, fft // 2 + 1),
    time-major as the JAX function returns it, on the mesh's first device
    (``keep_sharded``: a ``ShardedTensor``, ``P(batch, time, None)``).
    The input may be a ``ShardedTensor`` ``P(batch, time)``.

    Each shard runs the port's STFT (``ops.fft.rfft``: the FFT kernel at
    pow2 2048..32768 on the card) on its block and halo.  B must divide the
    ``data`` axis, n the ``time`` axis, and a block must be a multiple of
    ``slide_length`` no shorter than ``fft - slide``."""
    halo = fft_length - slide_length
    window = np.asarray(window, np.float32)
    win = {}

    def run(x):
        n, shards = _time_blocks(x, mesh, batch_axis, time_axis,
                                 slide_length, halo, "sharded stft")
        tv = valid_frames(n, fft_length, slide_length)
        n_b = mesh.shape[batch_axis]
        out = sink(mesh, (batch_axis, time_axis, None), keep_sharded)
        for i, j, dev, ext in shards:
            w = win.setdefault(str(dev), place(window, dev))
            with on(dev):
                D = _stft_impl(ext, w, fft_length=fft_length,
                               slide_length=slide_length, is_pad=False,
                               position=0, mode=0).transpose(-1, -2)
                t_loc = D.shape[-2]
                D = _frame_mask(D, j * t_loc, tv, -2)
            _put_frames(out, D, i, n_b, j * t_loc, tv, -2,
                        position(mesh, **{batch_axis: i, time_axis: j}))
        return out.out

    return run


def sharded_istft_fn(mesh: Mesh, fft_length: int, slide_length: int, window,
                     method_type: int = 0,
                     batch_axis: str = "data", time_axis: str = "time",
                     keep_sharded: bool = False):
    """Inverse of :func:`sharded_stft_fn`: (B, T, fft // 2 + 1) complex ->
    (B, (T - 1) * slide + fft) on the mesh's first device
    (``keep_sharded``: a ``ShardedTensor``, ``P(batch, time)``, shard
    ``j`` holding samples from ``j * T_loc * slide``).

    Any T: the frames are zero-padded to ``t_pad = ceil((T + ceil(halo /
    slide)) / n_time) * n_time`` (every shard equal, and the last frame's
    spill inside the padded length).  Each shard inverts its frames
    (``ops.fft.irfft``: the inverse FFT kernel on the card), masks the
    padded ones out of the overlap-add and the norm, and the tails go one
    shard to the right.  A ``ShardedTensor`` input ``P(batch, time,
    None)`` gives each shard its ``T_loc = t_pad / n_time`` frames where
    they lie: :func:`sharded_stft_fn`'s kept output holds exactly those,
    so only the tails cross devices."""
    halo = fft_length - slide_length
    e = 1.0 if method_type == 0 else 0.0
    window = np.asarray(window, np.float32)
    k = -(-fft_length // slide_length)
    consts = {}

    def local(D_loc, dev, start, t_orig):
        key = str(dev)
        if key not in consts:
            w = place(window, dev)
            consts[key] = (w.pow(e), w.pow(e + 1.0))
        w1, w2 = consts[key]
        frames = afft.irfft(D_loc, n=fft_length, dim=-1)   # (B, T_loc, fft)
        T_loc = frames.shape[-2]
        out_len = T_loc * slide_length + halo
        contrib = _frame_mask(frames * w1, start, t_orig, -2)
        normc = _frame_mask(w2.expand(T_loc, fft_length), start, t_orig, -2)
        y = _overlap_add(contrib.split(slide_length, dim=-1), T_loc, k,
                         slide_length)[..., :out_len]
        norm = _overlap_add(normc.split(slide_length, dim=-1), T_loc, k,
                            slide_length)[..., :out_len]
        return y, norm

    def run(D):
        grid = mesh.grid(batch_axis, time_axis)
        n_b, n_t = grid.shape
        D = sharded_input(D, mesh, (batch_axis, time_axis, None),
                          "sharded istft")
        if D.ndim != 3:
            raise ValueError(f"sharded istft expects (B, T, fre), got "
                             f"{tuple(D.shape)}")
        B, t, _ = D.shape
        if B % n_b:
            raise ValueError(f"batch {B} must divide the batch mesh axis "
                             f"({n_b})")
        k1 = -(-halo // slide_length)
        t_pad = -(-(t + k1) // n_t) * n_t
        T_loc = t_pad // n_t
        if T_loc * slide_length < halo:
            raise ValueError(f"sharded istft: {t} frames give each of the "
                             f"{n_t} shards {T_loc}, whose "
                             f"{T_loc * slide_length} samples do not cover "
                             f"the halo fft - slide = {halo}")
        kept = isinstance(D, ShardedTensor)
        if kept:
            b_loc = B // n_b

            def frames_of(i, j, dev):
                lo = min(j * T_loc, t)
                blk = D.take((slice(i * b_loc, (i + 1) * b_loc),
                              slice(lo, min((j + 1) * T_loc, t))), dev,
                             torch.complex64)
                return torch.nn.functional.pad(
                    blk, (0, 0, 0, T_loc - blk.shape[-2]))
            row_parts = range(n_b)
        else:
            if not isinstance(D, torch.Tensor):
                D = torch.from_numpy(np.asarray(D, np.complex64))
            D = torch.nn.functional.pad(D, (0, 0, 0, t_pad - t))
            row_parts = torch.tensor_split(D, n_b, dim=0)

            def frames_of(rows, j, dev):
                return rows[:, j * T_loc:(j + 1) * T_loc].to(
                    device=dev, dtype=torch.complex64, non_blocking=True)
        n_out = (t - 1) * slide_length + fft_length
        out = sink(mesh, (batch_axis, time_axis), keep_sharded)
        for i, rows in enumerate(row_parts):
            ys, norms = [], []
            for j in range(n_t):
                dev = grid[i, j]
                blk = frames_of(rows, j, dev)
                with on(dev):
                    y, norm = local(blk, dev, j * T_loc, t)
                ys.append(y)
                norms.append(norm)
            for j in range(n_t):
                dev = grid[i, j]
                # halo add-back: the left neighbour's tail lands on my
                # head; shard 0 takes no wrap from the last shard
                y, norm = ys[j][..., :-halo], norms[j][:-halo]
                if j > 0:
                    y = torch.cat([y[..., :halo] + ys[j - 1][..., -halo:].to(
                        dev, non_blocking=True), y[..., halo:]], dim=-1)
                    norm = torch.cat([norm[:halo] + norms[j - 1][-halo:].to(
                        dev, non_blocking=True), norm[halo:]])
                with on(dev):
                    norm = torch.where(norm < 1e-6, torch.ones_like(norm),
                                       norm)
                    y = y / norm
                _put_frames(out, y, i, n_b, j * T_loc * slide_length,
                            n_out, -1,
                            position(mesh, **{batch_axis: i, time_axis: j}))
        return out.out

    return run


def sharded_spectrogram_fn(plan, mesh: Mesh,
                           batch_axis: str = "data", time_axis: str = "time",
                           with_xxcc: int = 0, fused: bool = False,
                           fused_tile: int = 200,
                           fused_interpret: bool = False,
                           keep_sharded: bool = False):
    """A sharded filterbank spectrogram from a port plan: (B, n) ->
    (B, num, T_valid) on the mesh's first device, the unsharded
    ``plan.spectrogram``'s frame count.  With ``with_xxcc`` > 0 it returns
    (spec, xxcc) with that many coefficients (``plan.xxcc``'s log10 and
    DCT).  ``keep_sharded``: each output a ``ShardedTensor``, ``P(batch,
    None, time)``.  The input may be a ``ShardedTensor`` ``P(batch,
    time)``.

    ``fused=True`` runs each shard through the fused mel+MFCC kernel
    (``ops.fused_mel.fused_mel_mfcc``, ``fast=True``) on ``block ‖ halo``,
    ``n_loc + fft - slide`` samples, which it frames into exactly
    ``n_loc / slide`` frames: it needs the plan's POWER data type,
    128 | slide and ``with_xxcc`` > 0, and returns (spec, cc).  The plain
    form runs the plan's own single-device spectrogram on each shard (the
    FFT kernel at 2048..32768 on the card).  ``fused_tile`` and
    ``fused_interpret`` (the TPU kernel's tile and interpret mode) are
    accepted and unused."""
    fft_length = plan.fft_length
    slide = plan.slide_length
    halo = fft_length - slide
    if fused and (not with_xxcc or int(plan.data_type) == 1):
        raise ValueError("fused sharded path needs POWER data type "
                         "and with_xxcc > 0")
    fplans = {}

    def fused_plan(dev):
        key = str(dev)
        if key not in fplans:
            fplans[key] = FusedMelPlan(plan.window, plan.filter_bank,
                                       plan._dct[:with_xxcc], slide,
                                       device=dev)
        return fplans[key]

    def local(ext, dev):
        if fused:
            return fused_mel_mfcc(fused_plan(dev), ext, fast=True)
        p = replica(plan, dev)
        spec = p._run(ext)
        if with_xxcc:
            return spec, xxcc_from_spec(spec, p._dct_t, with_xxcc)
        return (spec,)

    def run(x):
        n, shards = _time_blocks(x, mesh, batch_axis, time_axis, slide,
                                 halo, "sharded spectrogram")
        tv = valid_frames(n, fft_length, slide)
        n_b = mesh.shape[batch_axis]
        outs = None
        for i, j, dev, ext in shards:
            with on(dev):
                res = local(ext, dev)
                t_loc = res[0].shape[-1]
                res = [_frame_mask(r, j * t_loc, tv, -1) for r in res]
            if outs is None:
                outs = [sink(mesh, (batch_axis, None, time_axis),
                              keep_sharded) for _ in res]
            pos = position(mesh, **{batch_axis: i, time_axis: j})
            for out, r in zip(outs, res):
                _put_frames(out, r, i, n_b, j * t_loc, tv, -1, pos)
        res = [o.out for o in outs]
        return tuple(res) if len(res) > 1 else res[0]

    return run
