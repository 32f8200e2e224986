"""A dry run of the whole parallel family at small sizes.

Counterpart of the JAX package's ``dryrun_multichip`` (``__graft_entry__.py``)
over the port's parallel API: the sharded mel (plain and fused), the
spectral statistics, the STFT round trip, every band-sharded and spliced
transform, the pipeline and the batch map, on a ``(data, time)`` mesh of
``n_devices`` shards.  ``devices=None`` means the visible CUDA devices
(it raises without one); pass ``[torch.device("cpu")] * n`` to run it on
the CPU, or ``[torch.device("cuda:0")] * n`` for one card.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.mir.hpss import HPSS
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.parallel.mesh import make_mesh
from audioflux_torch.parallel.features import sharded_spectral_stats_fn
from audioflux_torch.parallel.pipeline import pipeline_chain_fn
from audioflux_torch.parallel.sharded import (sharded_istft_fn,
                                              sharded_spectrogram_fn,
                                              sharded_stft_fn)
from audioflux_torch.parallel.sharded_full import (
    sharded_batch_map_fn, sharded_ccwt_fn, sharded_cqt_fn, sharded_cst_fn,
    sharded_cwt_fn, sharded_fst_fn, sharded_nsgt_fn, sharded_st_fn,
    sharded_synsq_fn, sharded_wsst_fn)
from audioflux_torch.transforms.cqt import CQT
from audioflux_torch.transforms.cwt import CWT
from audioflux_torch.transforms.fst import FST
from audioflux_torch.transforms.nsgt import NSGT
from audioflux_torch.transforms.spectrogram import MelSpectrogram
from audioflux_torch.transforms.st import ST
from audioflux_torch.transforms.synsq import Synsq
from audioflux_torch.transforms.wsst import WSST
from audioflux_torch.types import WindowType

__all__ = ["dryrun_multichip"]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run every parallel path once on ``n_devices`` shards and check the
    shapes (and the pipeline against the direct composition); raises on
    the first failure."""
    data = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    time = n_devices // data
    mesh = make_mesh(data=data, time=time, devices=devices)
    d = {"device": mesh.first}
    rng = np.random.default_rng(0)

    # data-parallel clips x sequence-parallel frame blocks
    plan = MelSpectrogram(num=128, samplate=32000, radix2_exp=8,
                          slide_length=64, **d)
    block = 4 * plan.slide_length
    x = rng.standard_normal((2 * data, block * time)).astype(np.float32) * 0.1
    spec, cc = sharded_spectrogram_fn(plan, mesh, with_xxcc=13)(x)
    t_valid = 4 * time - 3
    _check(tuple(spec.shape) == (2 * data, 128, t_valid), f"mel {spec.shape}")
    _check(tuple(cc.shape) == (2 * data, 13, t_valid), f"cc {cc.shape}")

    t_stats = time * (t_valid // time) if t_valid >= time else t_valid
    stats = sharded_spectral_stats_fn(mesh)(spec[..., :t_stats])
    _check(tuple(stats["mean"].shape) == (2 * data, 128), "stats")

    win = get_fft_window(WindowType.HANN, plan.fft_length)
    D = sharded_stft_fn(mesh, plan.fft_length, plan.slide_length, win)(x)
    y = sharded_istft_fn(mesh, plan.fft_length, plan.slide_length, win)(D)
    _check(tuple(y.shape) == x.shape, f"istft {y.shape}")

    # the fused mel+MFCC kernel per shard
    plan2 = MelSpectrogram(num=128, samplate=32000, radix2_exp=11,
                           slide_length=512, **d)
    x2 = rng.standard_normal((2 * data, 8 * 512 * time)).astype(
        np.float32) * 0.1
    mel2, cc2 = sharded_spectrogram_fn(plan2, mesh, with_xxcc=13,
                                       fused=True)(x2)
    _check(tuple(mel2.shape) == (2 * data, 128, 8 * time - 3),
           f"fused {mel2.shape}")
    _check(tuple(cc2.shape) == (2 * data, 13, 8 * time - 3), "fused cc")

    # band-sharded full-signal transforms and the spliced long ones
    cw = CWT(num=12, radix2_exp=9, samplate=32000, **d)
    xc = rng.standard_normal((2 * data, 512)).astype(np.float32)
    _check(tuple(sharded_cwt_fn(cw, mesh)(xc).shape) == (2 * data, 12, 512),
           "cwt")
    sharded_synsq_fn(cw, Synsq(num=12, radix2_exp=9, samplate=32000, **d),
                     mesh, mode="shard_map")(xc)
    sharded_wsst_fn(WSST(num=12, radix2_exp=9, samplate=32000, **d),
                    mesh)(xc)
    stq = ST(radix2_exp=9, samplate=32000, min_index=1, max_index=40, **d)
    sharded_st_fn(stq, mesh)(xc)
    sharded_nsgt_fn(NSGT(num=12, radix2_exp=9, samplate=32000, **d),
                    mesh)(xc)
    cq = CQT(num=12, samplate=32000, bin_per_octave=12, low_fre=880.0, **d)
    sharded_cqt_fn(cq, mesh)(rng.standard_normal((data * time, 2048)).astype(
        np.float32))
    xl = rng.standard_normal(
        (2 * data, time * 2 * (cw.fft_length // 2))).astype(np.float32)
    Cc = sharded_ccwt_fn(cw, mesh)(xl)
    _check(tuple(Cc.shape) == (2 * data, 12, xl.shape[-1]), f"ccwt {Cc.shape}")
    fst = FST(radix2_exp=9, samplate=32000, min_index=1, max_index=40, **d)
    Ft = sharded_fst_fn(fst, mesh)(xc)
    _check(tuple(Ft.shape) == (2 * data, 40, 512), f"fst {Ft.shape}")
    xs = rng.standard_normal(
        (2 * data, time * 2 * (stq.fft_length // 2))).astype(np.float32)
    Cst = sharded_cst_fn(stq, mesh)(xs)
    _check(tuple(Cst.shape) == (2 * data, len(stq.bin_arr), xs.shape[-1]),
           f"cst {Cst.shape}")

    # pipeline: a frame -> power -> mel -> log chain staged over 'time'
    wn = torch.from_numpy(np.hanning(128).astype(np.float32))
    fb = torch.from_numpy(np.abs(np.random.default_rng(2).standard_normal(
        (65, 16))).astype(np.float32))
    ops = [
        lambda v: v.reshape(v.shape[0], 4, 128) * wn.to(v.device),
        lambda v: torch.fft.rfft(v, dim=-1).abs() ** 2,
        lambda v: v @ fb.to(v.device),
        lambda v: torch.log10(v + 1.0),
    ]
    op_shapes = [(512,), (4, 128), (4, 65), (4, 16), (4, 16)]
    buckets = np.array_split(np.arange(len(ops)), time)

    def stage(idxs):
        def fn(v):
            for i in idxs:
                v = ops[i](v)
            return v
        return fn

    stages = [stage(list(b)) for b in buckets]
    shapes = [op_shapes[b[0]] for b in buckets] + [op_shapes[-1]]
    xp = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4 * time, 512)).astype(np.float32)).to(mesh.first)
    got = pipeline_chain_fn(stages, shapes, mesh, axis="time",
                            n_micro=time)(xp)
    want = xp
    for op in ops:
        want = op(want)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)

    # the batch map over a kernel-bearing pipeline (HPSS: FFT and median)
    hp = HPSS(radix2_exp=11, slide_length=512, **d)
    xb = rng.standard_normal((2 * data * time, 16384)).astype(np.float32)
    hb, _ = sharded_batch_map_fn(hp.hpss, mesh)(xb)
    _check(tuple(hb.shape) == xb.shape, f"hpss {hb.shape}")
