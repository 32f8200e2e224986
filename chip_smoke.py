"""End-to-end check of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no result line is printed then):

0. card identity (nvidia-smi name and power limit, torch and CUDA
   versions; sm_90 required; fp32 matmuls must not use TF32);
1. build every kernel from ``audioflux_torch/csrc`` with nvcc;
2. each kernel against its plain PyTorch version on the card;
3. the main path at full size: ``MelSpectrogram(num=128, samplate=32000,
   radix2_exp=11, slide_length=512).spectrogram_mfcc_fused`` on 1000 clips
   of T=1000 frames, the T<8 path on 1000 clips of 4096 samples and
   ``.spectrogram()`` on the card, each gated against ``.spectrogram()``
   on the CPU at 1e-4 of the peak (first and last clips), and the whole
   batch against the plain versions on the card; both kernels' launch
   counts must be nonzero;
4. timing with CUDA events: each kernel, its plain version and the
   library yardstick at the main path's shapes, the fused kernel cut
   after each stage (its split), and the headline audio-hours per
   second.

The second-to-last line is the kernels JSON object; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from audioflux_torch.ops import _build  # noqa: E402
from audioflux_torch.ops.cuda_fft import fft_fwd, fft_fwd_ref  # noqa: E402
from audioflux_torch.ops.fused_mel import (FusedMelPlan,  # noqa: E402
                                           _launch, fused_mel_mfcc,
                                           fused_mel_mfcc_ref)
from audioflux_torch.transforms.spectrogram import (  # noqa: E402
    ErbSpectrogram, MelSpectrogram)
from audioflux_torch.types import WindowType  # noqa: E402

SR, NUM, R2E, SLIDE, T_HEAD, N_CLIPS, CC = 32000, 128, 11, 512, 1000, 1000, 13
FFT_TOL, FP32_TOL, FAST_TOL, GATE_TOL = 5e-5, 1e-5, 2e-4, 1e-4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, fp32 outside tensor cores


def phase(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def check(name, err, tol):
    print(f"  {name}: max err / peak = {err:.3e} (tol {tol:.0e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: {err:.3e} > {tol:.0e}")


def cuda_ms(fn, reps=10, warmup=2):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def randn(shape, gen, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.float32) * scale


def phase0_identity():
    phase("phase 0: card identity")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs an H100")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"  nvidia-smi: {smi}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"need an sm_90 card, found capability {cap}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SystemExit("torch.backends.cuda.matmul.allow_tf32 must be False")
    return smi.splitlines()[0]


def phase1_build():
    phase("phase 1: build kernels (nvcc, sm_90a)")
    t0 = time.perf_counter()
    reports = _build.build(verbose=True)
    seconds = time.perf_counter() - t0
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"  build seconds: {seconds:.2f}")


def phase2_kernels(gen):
    phase("phase 2: kernels against their plain versions")
    # max |kernel - plain| at the main path's n_fft, for the kernels line
    errs = {"fft_pow2": 0.0, "fused_mel_mfcc": 0.0}
    for n in (2048, 4096, 8192, 16384, 32768):
        xr = randn((64, n), gen)
        xi = randn((64, n), gen)
        for label, args in (("real", (xr,)), ("complex", (xr, xi))):
            yr, yi = fft_fwd(*args)
            rr, ri = fft_fwd_ref(*args)
            torch.cuda.synchronize()
            peak = float(torch.sqrt(rr.double() ** 2 + ri.double() ** 2).max())
            abs_err = max(float((yr - rr).abs().max()),
                          float((yi - ri).abs().max()))
            check(f"fft_pow2 n={n} {label}", abs_err / peak, FFT_TOL)
            if n == 1 << R2E:
                errs["fft_pow2"] = max(errs["fft_pow2"], abs_err)

    # the headline, then every shape class of the kernel: n_fft 128..16384
    # (one round per tile up to four), odd bands, cosine and plain windows
    configs = [
        ("headline mel128 2048/512 hann", MelSpectrogram, dict(
            num=NUM, radix2_exp=R2E, slide_length=SLIDE), 8, T_HEAD, CC),
        ("erb64 4096/1024 blackman", ErbSpectrogram, dict(
            num=64, radix2_exp=12, slide_length=1024,
            window_type=WindowType.BLACKMAN), 3, 333, 4),
        ("mel32 512/128 hann", MelSpectrogram, dict(
            num=32, radix2_exp=9, slide_length=128), 2, 101, 5),
        ("mel64 1024/256 hamm", MelSpectrogram, dict(
            num=64, radix2_exp=10, slide_length=256,
            window_type=WindowType.HAMM), 2, 57, 13),
        ("mel64 2048/2048 rect", MelSpectrogram, dict(
            num=64, radix2_exp=11, slide_length=2048,
            window_type=WindowType.RECT), 2, 17, 5),
        ("mel24 128/128 hann", MelSpectrogram, dict(
            num=24, radix2_exp=7, slide_length=128), 2, 40, 5),
        ("mel128 8192/2048 hann", MelSpectrogram, dict(
            num=128, radix2_exp=13, slide_length=2048), 2, 30, 13),
        ("mel256 16384/4096 hann", MelSpectrogram, dict(
            num=256, radix2_exp=14, slide_length=4096), 2, 21, 20),
    ]
    for label, cls, kw, batch, T, cc_num in configs:
        sp = cls(samplate=SR, device="cuda", **kw)
        plan = FusedMelPlan(sp.window, sp.filter_bank, sp._dct[:cc_num],
                            sp.slide_length, device="cuda")
        x = randn((batch, (T - 1) * sp.slide_length + sp.fft_length), gen, 0.2)
        mel_r, cc_r = fused_mel_mfcc_ref(plan, x)
        for fast, tol in ((False, FP32_TOL), (True, FAST_TOL)):
            mel, cc = fused_mel_mfcc(plan, x, fast=fast)
            torch.cuda.synchronize()
            if mel.shape != mel_r.shape or cc.shape != cc_r.shape:
                raise AssertionError(f"{label}: shape {tuple(mel.shape)}")
            for what, a, b in (("mel", mel, mel_r), ("cc", cc, cc_r)):
                check(f"fused {label} fast={fast} {what}", rel_err(a, b),
                      tol)
                if not fast and label.startswith("headline"):
                    errs["fused_mel_mfcc"] = max(
                        errs["fused_mel_mfcc"],
                        float((a - b).abs().max()))

    # inputs at addresses that are not 16-byte aligned: a 1-D clip viewed
    # at an offset of one sample, and clips of odd length (every other
    # clip starts off alignment)
    sp = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                        slide_length=SLIDE, device="cuda")
    plan = FusedMelPlan(sp.window, sp.filter_bank, sp._dct[:CC], SLIDE,
                        device="cuda")
    n = (40 - 1) * SLIDE + sp.fft_length
    for label, x in (("1-D view at offset 1", randn(n + 1, gen, 0.2)[1:]),
                     ("4 clips of odd length", randn((4, n + 1), gen, 0.2))):
        mel, cc = fused_mel_mfcc(plan, x)
        torch.cuda.synchronize()
        mel_r, cc_r = fused_mel_mfcc_ref(plan, x.clone())
        for what, a, b in (("mel", mel, mel_r), ("cc", cc, cc_r)):
            check(f"fused {label} {what}", rel_err(a, b), FP32_TOL)
    return errs


def gate(label, dev_out, plan_cpu, x_cpu):
    ref = plan_cpu.spectrogram(x_cpu)
    check(f"gate {label} vs CPU .spectrogram()",
          rel_err(dev_out.cpu(), ref), GATE_TOL)
    return ref


def phase3_main_path(gen):
    phase("phase 3: main path at full size")
    plan = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                          slide_length=SLIDE, device="cuda")
    plan_cpu = MelSpectrogram(num=NUM, samplate=SR, radix2_exp=R2E,
                              slide_length=SLIDE, device="cpu")
    clip_len = (T_HEAD - 1) * SLIDE + (1 << R2E)  # 513536 samples
    x = randn((N_CLIPS, clip_len), gen, 0.2)
    xs = randn((N_CLIPS, 4096), gen, 0.2)
    torch.cuda.synchronize()

    fft_fwd.launches = 0
    fused_mel_mfcc.launches = 0
    mel, cc = plan.spectrogram_mfcc_fused(x, cc_num=CC)
    mel_s, cc_s = plan.spectrogram_mfcc_fused(xs, cc_num=CC)
    spec = plan.spectrogram(x[:8])
    torch.cuda.synchronize()
    launches = {"fused_mel_mfcc": fused_mel_mfcc.launches,
                "fft_pow2": fft_fwd.launches}
    print(f"  launches on the main path: {launches}")

    for name, t, shape in (("mel", mel, (N_CLIPS, NUM, T_HEAD)),
                           ("cc", cc, (N_CLIPS, CC, T_HEAD)),
                           ("mel T=5", mel_s, (N_CLIPS, NUM, 5)),
                           ("cc T=5", cc_s, (N_CLIPS, CC, 5))):
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} or "
                                 "non-finite values")
    # the whole batch against the plain version on the card, in chunks
    fplan = plan._fused_cache[CC]
    err_mel = err_cc = 0.0
    for lo in range(0, N_CLIPS, 250):
        mel_r, cc_r = fused_mel_mfcc_ref(fplan, x[lo:lo + 250])
        err_mel = max(err_mel, rel_err(mel[lo:lo + 250], mel_r))
        err_cc = max(err_cc, rel_err(cc[lo:lo + 250], cc_r))
        del mel_r, cc_r
    check(f"fused mel (T=1000, all {N_CLIPS} clips) vs plain", err_mel,
          FP32_TOL)
    check(f"fused cc (T=1000, all {N_CLIPS} clips) vs plain", err_cc,
          FP32_TOL)
    mel_r, cc_r = fused_mel_mfcc_ref(fplan, xs)
    check(f"small-T mel (T=5, all {N_CLIPS} clips) vs plain",
          rel_err(mel_s, mel_r), FFT_TOL)
    check(f"small-T cc (T=5, all {N_CLIPS} clips) vs plain",
          rel_err(cc_s, cc_r), FFT_TOL)
    rows_w = (xs.unfold(-1, plan.fft_length, SLIDE)
              * plan._window_t).contiguous()
    yr, yi = fft_fwd(rows_w)
    rr, ri = fft_fwd_ref(rows_w)
    peak = float(torch.sqrt(rr.double() ** 2 + ri.double() ** 2).max())
    check(f"fft_pow2 all {rows_w.numel() // plan.fft_length} small-T rows "
          "vs plain", max(float((yr - rr).abs().max()),
                          float((yi - ri).abs().max())) / peak, FFT_TOL)

    # the exact path on the CPU, at the first and the last clips
    for sl, at in ((slice(0, 2), "first"), (slice(-2, None), "last")):
        ref = gate(f"fused mel (T=1000, {at} 2 clips)", mel[sl], plan_cpu,
                   x[sl].cpu())
        check(f"fused cc (T=1000, {at} 2 clips) vs CPU xxcc",
              rel_err(cc[sl].cpu(), plan_cpu.xxcc(ref, CC)), GATE_TOL)
        ref_s = gate(f"small-T mel (T=5, {at} 2 clips)", mel_s[sl],
                     plan_cpu, xs[sl].cpu())
        check(f"small-T cc (T=5, {at} 2 clips) vs CPU xxcc",
              rel_err(cc_s[sl].cpu(), plan_cpu.xxcc(ref_s, CC)), GATE_TOL)
    gate(".spectrogram() on the card (first 2 of 8 clips)", spec[:2],
         plan_cpu, x[:2].cpu())
    gate(".spectrogram() on the card (last 2 of 8 clips)", spec[-2:],
         plan_cpu, x[6:8].cpu())
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was not launched on the main path")
    return plan, x, xs, launches


def phase4_timing(plan, x, xs, launches, errs):
    phase("phase 4: timing (CUDA events, median)")
    rows = []

    # --- fused_mel_mfcc at the headline shape --------------------------
    fplan = plan._fused_cache[CC]
    B, n = x.shape
    T = (n - plan.fft_length) // SLIDE + 1
    k_ms = cuda_ms(lambda: fused_mel_mfcc(fplan, x), reps=10)
    chunks = torch.split(x, 250)
    p_ms = cuda_ms(lambda: [fused_mel_mfcc_ref(fplan, c) for c in chunks],
                   reps=3, warmup=1)
    frames_w = [(c.unfold(-1, plan.fft_length, SLIDE) * fplan.window)
                .contiguous() for c in chunks]

    def library():
        for f in frames_w:
            s = torch.fft.rfft(f, dim=-1)
            mel = torch.matmul(s.real.square() + s.imag.square(),
                               fplan.mel_fb.T)
            torch.matmul(torch.log10(torch.clamp(mel, min=1e-8)),
                         fplan.dct.T)
    l_ms = cuda_ms(library, reps=3, warmup=1)
    del frames_w
    nfft = plan.fft_length
    frames = B * T
    n_bytes = 4 * (B * n + B * (NUM + CC) * T)
    n_flops = frames * (2.5 * nfft * math.log2(nfft) + 2 * fplan.band_nnz
                        + NUM + 2 * CC * NUM)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    rows.append({"name": "fused_mel_mfcc", "route": "cuda",
                 "source": "audioflux_torch/csrc/fused_mel_mfcc.cu",
                 "replaces": "audioflux_tpu/ops/pallas_spectrogram.py:1250",
                 "launches": launches["fused_mel_mfcc"],
                 "max_abs_err": errs["fused_mel_mfcc"], "ms": k_ms,
                 "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": l_ms})
    print(f"  fused_mel_mfcc {B}x{n}: kernel {k_ms:.3f} ms, plain "
          f"{p_ms:.3f} ms, library {l_ms:.3f} ms, bound {b_ms:.3f} ms "
          f"({b_by}: {n_bytes / 1e9:.3f} GB, {n_flops / 1e9:.2f} GFLOP)")

    # the kernel cut after each stage: the differences split its time
    cut_ms = [cuda_ms(lambda s=s: _launch(fplan, x, T, stages=s), reps=10)
              for s in (1, 2, 3)] + [k_ms]
    for s, name in enumerate(("framing (audio load + window)",
                              "transform", "power + filterbank + log10",
                              "DCT")):
        prev = cut_ms[s - 1] if s else 0.0
        print(f"  split: {name}: {cut_ms[s] - prev:.3f} ms "
              f"(cut after it: {cut_ms[s]:.3f} ms)")

    # headline end to end: the user's call, audio-hours per second
    e2e_ms = cuda_ms(lambda: plan.spectrogram_mfcc_fused(x, cc_num=CC),
                     reps=10)
    audio_hours = B * n / SR / 3600.0
    print(f"  headline spectrogram_mfcc_fused {B}x T={T}: {e2e_ms:.3f} ms, "
          f"{audio_hours / (e2e_ms / 1e3):.1f} audio-hours/s; outside the "
          f"kernel (difference of medians): {e2e_ms - k_ms:.3f} ms")

    # --- fft_pow2 at the small-T path's shape (1000 clips x 5 frames) --
    rows_w = (xs.unfold(-1, nfft, SLIDE) * plan._window_t).contiguous()
    k_ms = cuda_ms(lambda: fft_fwd(rows_w), reps=20)
    p_ms = cuda_ms(lambda: fft_fwd_ref(rows_w), reps=20)
    l_ms = cuda_ms(lambda: torch.fft.fft(rows_w, dim=-1), reps=20)
    nrows = rows_w.numel() // nfft
    n_bytes = 4 * rows_w.numel() + 8 * rows_w.numel()
    n_flops = nrows * 5.0 * nfft * math.log2(nfft)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    rows.append({"name": "fft_pow2", "route": "cuda",
                 "source": "audioflux_torch/csrc/fft_pow2.cu",
                 "replaces": "audioflux_tpu/ops/pallas_fft.py:346",
                 "launches": launches["fft_pow2"],
                 "max_abs_err": errs["fft_pow2"], "ms": k_ms,
                 "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": l_ms})
    print(f"  fft_pow2 {nrows}x{nfft} real: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, library {l_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    e2e_s = cuda_ms(lambda: plan.spectrogram_mfcc_fused(xs, cc_num=CC),
                    reps=20)
    hours_s = xs.shape[0] * xs.shape[1] / SR / 3600.0
    print(f"  small-T spectrogram_mfcc_fused {xs.shape[0]}x{xs.shape[1]}: "
          f"{e2e_s:.4f} ms, {hours_s / (e2e_s / 1e3):.1f} audio-hours/s")
    # the fused kernel at the same T=5 batch, beside the small-T route
    f_ms = cuda_ms(lambda: fused_mel_mfcc(fplan, xs), reps=20)
    print(f"  fused_mel_mfcc at the small-T batch {xs.shape[0]}x"
          f"{xs.shape[1]}: {f_ms:.4f} ms (small-T route {e2e_s:.4f} ms)")
    return rows


def main():
    smi = phase0_identity()
    phase1_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = phase2_kernels(gen)
    plan, x, xs, launches = phase3_main_path(gen)
    rows = phase4_timing(plan, x, xs, launches, errs)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
