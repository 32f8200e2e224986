"""Time the FFT calls that the pitch engines and ``xcorr`` make at 8192 and
32768, as each tree's code makes them, on one CUDA card: an A/B of two
checkouts of ``audioflux_torch`` in one process each.

    python3 tools/fft_route_ab.py [--root DIR] [--label NAME]

``--root`` is the checkout whose ``audioflux_torch`` is imported (default:
this one); compare two commits by running the script once per checkout in
one session on one card, in the order A, B, B, A.  Each run prints the
card (``nvidia-smi`` name and power limit) and one JSON line of median
CUDA-event times in ms: the engines' FFT calls on config 5's 8 clips of
30 s (7,472 frames; HPS's forward and the bins it keeps, PEF's frames,
cross-correlation forward and real-output inverse), ``xcorr``'s forward
and inverse on 1000 clips of 4096, the complex forward and inverse at
32768, the autocorrelation of NCF's rows (the general entry on the two
operands, and the call NCF makes: the frames entry where the tree has it)
and of random rows at 16384 and 32768, the complex forward and inverse
at 8192 and 16384 on 7,472 random rows beside ``torch.fft.fft`` and
``ifft``, the complex forward at 4096 over 131,072 rows and the complex
inverse of Hilbert's 1000 rows of 4096 beside ``torch.fft``, and the
users' calls ``PitchHPS``/``PitchLHS``/``PitchPEF``/``PitchNCF.pitch``,
``HarmonicRatio.harmonic_ratio``, ``xcorr`` and ``czt`` (1000 clips of
4096, L = 8192).  Beside them the host
time of ``xcorr``'s forward (``fft_parts(x, n=8192, bins=4097)`` on 1000
rows of 4096): through ``ops.fft.fft_parts``, ``cuda_fft.fft_fwd`` and
a bare call of the C entry with its arguments made beforehand, each as
the host clock's microseconds a call (the median of 7 batches of 200
calls queued without a synchronisation, ``*_host_us``) and as CUDA-event
ms, against ``torch.fft.rfft``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys

import torch


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    sys.path.insert(0, os.path.abspath(args.root))
    import torch.nn.functional as F
    from audioflux_torch.dsp import czt, xcorr
    from audioflux_torch.mir import PitchHPS, PitchLHS, PitchPEF
    from audioflux_torch.ops import cuda_fft
    from audioflux_torch.ops import fft as afft

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    # what the two trees' code calls differs: before the real-row route,
    # fft_fwd had no ``bins`` and xcorr inverted with ``ifft(...).real``
    has_bins = "bins" in inspect.signature(cuda_fft.fft_fwd).parameters
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sr, clips, seconds = 32000, 8, 30
    t = torch.arange(seconds * sr, device="cuda") / sr
    f0 = 220.0 * (1.0 + 0.02 * torch.sin(2 * torch.pi * 5.0 * t))
    tone = 0.5 * torch.sin(2 * torch.pi * torch.cumsum(f0, 0) / sr)
    x = (tone + 0.05 * torch.randn((clips, t.numel()), generator=gen,
                                   device="cuda")).contiguous()
    hps, lhs, pef = (c(samplate=sr, device="cuda")
                     for c in (PitchHPS, PitchLHS, PitchPEF))
    out = {"root": args.root, "label": args.label, "card": smi,
           "bins_api": has_bins}

    # HPS's forward: padded frames, the bins its gather reads
    X = hps.interp_fft_length
    rows = F.pad(hps._frames(x), (0, X - hps.fft_length)).contiguous()
    K = min(int(hps._hidx.max()) + 1, X)
    out["frames"] = rows.numel() // X
    out["hps_fwd"] = cuda_ms(lambda: afft.fft_parts(rows, bins=K)
                             if has_bins else afft.fft_parts(rows))
    del rows
    # PEF: its frames at 2N through the transform its code calls, the
    # cross-correlation rows' forward, the product's real inverse
    N = pef.fft_length
    frames = pef._frames(x)
    out["pef_frames_fwd"] = cuda_ms(
        lambda: afft.rfft(frames, n=2 * N, dim=-1) if has_bins
        else afft.fft(frames, n=2 * N, dim=-1)[..., :N + 1])
    buf = pef._xcorr_rows(x)
    out["pef_xcorr_fwd"] = cuda_ms(lambda: afft.fft_parts(buf))
    pr, pi = pef._xcorr_spectrum(buf)
    out["pef_inv_real"] = cuda_ms(
        lambda: afft.ifft_parts(pr, pi, real_only=True))
    # the complex forward at 32768 (the four-step route in both trees)
    out["complex_fwd_32768"] = cuda_ms(lambda: cuda_fft.fft_fwd(pr, pi))
    del frames, buf, pr, pi
    # xcorr's transforms at 8192 on 1000 clips of 4096, as it calls them
    xs = 0.2 * torch.randn((1000, 4096), generator=gen, device="cuda")
    ys = xs.roll(1, dims=0)
    F1 = afft.fft(xs, n=8192, dim=-1)
    prod = F1 * torch.conj(afft.fft(ys, n=8192, dim=-1))
    out["xcorr_fwd"] = cuda_ms(lambda: afft.fft(xs, n=8192, dim=-1))
    xinv = "ifft_parts" in inspect.getsource(xcorr)
    out["xcorr_inv"] = cuda_ms(
        lambda: afft.ifft_parts(prod.real, prod.imag, real_only=True)
        if xinv else afft.ifft(prod, dim=-1).real)
    del F1, prod
    # the complex inverse at 32768 (four-step route, then the clusters)
    pr, pi = (torch.randn((out["frames"], 32768), generator=gen,
                          device="cuda") for _ in range(2))
    out["complex_inv_32768"] = cuda_ms(lambda: cuda_fft.fft_inv(pr, pi))
    del pr, pi
    # the autocorrelation: NCF's operands through the general entry, NCF's
    # frames as the tree's autocorr_rows takes them, random rows
    from audioflux_torch.mir import HarmonicRatio, PitchNCF
    from audioflux_torch.mir import pitch as mpitch
    ncf = PitchNCF(samplate=sr, device="cuda")
    hr = HarmonicRatio(samplate=sr, device="cuda")
    fr = ncf._frames(x)
    ops = mpitch.autocorr_operands(fr, 8192)
    out["acf_8192_general"] = cuda_ms(lambda: cuda_fft.fft_autocorr(*ops))
    del ops
    lags = ncf.max_index + 1
    if "lags" in inspect.signature(mpitch.autocorr_rows).parameters:
        out["acf_8192_ncf_call"] = cuda_ms(
            lambda: mpitch.autocorr_rows(fr, 8192, lags))
    else:
        out["acf_8192_ncf_call"] = cuda_ms(
            lambda: mpitch.autocorr_rows(fr, 8192)[..., :lags])
    for n in (16384, 32768):
        a, b = (torch.randn((out["frames"], n), generator=gen, device="cuda")
                for _ in range(2))
        out[f"acf_{n}"] = cuda_ms(lambda: cuda_fft.fft_autocorr(a, b))
        del a, b
    # the complex rows at 8192 and 16384 (the row route) on 7,472 random
    # rows, beside torch.fft.fft and .ifft on the same rows
    for n in (8192, 16384):
        a, b = (torch.randn((out["frames"], n), generator=gen, device="cuda")
                for _ in range(2))
        z = torch.complex(a, b)
        out[f"complex_fwd_{n}"] = cuda_ms(lambda: cuda_fft.fft_fwd(a, b))
        out[f"complex_inv_{n}"] = cuda_ms(lambda: cuda_fft.fft_inv(a, b))
        out[f"fft_{n}"] = cuda_ms(lambda: torch.fft.fft(z, dim=-1))
        out[f"ifft_{n}"] = cuda_ms(lambda: torch.fft.ifft(z, dim=-1))
        del a, b, z
    # two readings at 4096 (the register route in both trees): the complex
    # forward over 131,072 rows (ST's inverse rows' count) and the complex
    # inverse of Hilbert's 1000 rows, each beside torch.fft
    a, b = (torch.randn((131072, 4096), generator=gen, device="cuda")
            for _ in range(2))
    z = torch.complex(a, b)
    out["complex_fwd_4096_131072"] = cuda_ms(lambda: cuda_fft.fft_fwd(a, b))
    out["fft_4096_131072"] = cuda_ms(lambda: torch.fft.fft(z, dim=-1))
    del a, b, z
    H = torch.fft.fft(xs, dim=-1)
    H[..., 1:2048] *= 2
    H[..., 2049:] = 0
    Hr, Hi = H.real.contiguous(), H.imag.contiguous()
    out["hilbert_inv_4096_1000"] = cuda_ms(lambda: cuda_fft.fft_inv(Hr, Hi))
    out["ifft_4096_1000"] = cuda_ms(lambda: torch.fft.ifft(H, dim=-1))
    del H, Hr, Hi
    # xcorr's forward at 8192 on 1000 rows: host and device time a call
    import time
    lib = cuda_fft._lib()
    yr = xs.new_empty((1000, 4097))
    yi = xs.new_empty((1000, 4097))
    tw = cuda_fft._kernel_table(8192, xs.device)
    stream = torch.cuda.current_stream().cuda_stream
    tail = (tw.data_ptr(), 1000, 13, 4097, 0, 4096, 3, stream)
    if len(lib.af_fft_pow2_fwd.argtypes) == 13:     # the scratch argument
        tail = (None,) + tail
    bare = (xs.data_ptr(), None, yr.data_ptr(), yi.data_ptr()) + tail
    calls = (("fft_parts", lambda: afft.fft_parts(xs, n=8192, bins=4097)),
             ("fft_fwd", lambda: cuda_fft.fft_fwd(xs, bins=4097, n=8192)),
             ("bare", lambda: lib.af_fft_pow2_fwd(*bare)),
             ("rfft", lambda: torch.fft.rfft(xs, n=8192)))
    for name, fn in calls:
        out[f"xcorr_fwd_{name}"] = cuda_ms(fn, reps=20)
        batches = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            batches.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
        out[f"xcorr_fwd_{name}_host_us"] = sorted(batches)[3]
    # the users' calls
    for name, fn in (("PitchHPS", lambda: hps.pitch(x)),
                     ("PitchLHS", lambda: lhs.pitch(x)),
                     ("PitchPEF", lambda: pef.pitch(x)),
                     ("PitchNCF", lambda: ncf.pitch(x)),
                     ("HarmonicRatio", lambda: hr.harmonic_ratio(x)),
                     ("xcorr", lambda: xcorr(xs, ys)),
                     ("czt", lambda: czt(xs, 0.1, 0.3))):
        out[name] = cuda_ms(fn, reps=5, warmup=1)
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
