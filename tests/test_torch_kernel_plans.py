"""The launch planners of the two cluster / register-resident kernels, and
an index model of each kernel's decomposition in plain PyTorch.

The CUDA kernels cannot run without the card, so what can go wrong in
them before any arithmetic does — which block, thread and register owns
which point — is mirrored here with the kernels' own index formulas and
held against the plain versions:

* ``cwt_ifft_bank``: the n1 x n2 split, block c's columns, the exchange
  through the peers' tiles with the four-step twiddle, block d's rows, the
  pairs of the store and its kept-sample mask;
* ``fused_mel_mfcc``: the A x B split of a packed frame pair, the group's
  transpose buffer, the rows k1 and A - k1 a thread ends with, the
  separation of the two frames from bins k and n - k, the bin-major
  powers and the filterbank over (band, four frames) items in the order
  of its rounds;
* ``fft_pow2``'s register route (n = 2048, 4096): the pairing of real
  rows (an odd batch's last row alone), the A x B split, the rows a thread
  ends with, the separation of a pair and the mirror half of each
  spectrum, the complex and inverse forms.

The CPU has no tolerance of its own here: the models use the same fp32
sub-transforms (``torch.fft``) as the plain versions, and 1e-5 of the peak
is the kernels' contract on the card.
"""

import numpy as np
import pytest
import torch

from audioflux_tpu.transforms.spectrogram import MelSpectrogram as JMel
from audioflux_torch.ops import cuda_cwt, fused_mel
from audioflux_torch.ops.cuda_fft import (fft_fwd_ref, fft_inv_ref,
                                          twiddle_table)
from audioflux_torch.ops.fused_mel import (FusedMelPlan, _launch_shape,
                                           _REG_SPLIT, fused_mel_mfcc_ref)
from audioflux_torch.transforms.spectrogram import MelSpectrogram

SMEM_MAX = 232448


# ---------------------------------------------------------------- planners

@pytest.mark.parametrize("e", [14, 15, 16, 17])
def test_cluster_plan_default(e):
    n = 1 << e
    p = cuda_cwt.cluster_plan(n)
    assert 1 <= p["cluster"] <= 8 and not p["cluster"] & (p["cluster"] - 1)
    assert p["n1"] * p["n2"] == n and p["n1"] == 1 << ((e + 1) // 2)
    assert p["ncol"] * p["cluster"] == p["n2"] and p["ncol"] >= 2
    assert p["nrow"] * p["cluster"] == p["n1"] and p["nrow"] >= 2
    assert p["points"] == p["ncol"] * p["n1"] == p["nrow"] * p["n2"]
    assert p["threads"] * 16 == p["points"] and p["threads"] <= 1024
    assert p["smem"] <= SMEM_MAX
    # two blocks share an SM (64 registers a thread, under half the shared
    # memory) at the 512-thread block, which the main path's N (2^16) and
    # everything below it gets
    assert p["blocks_per_sm"] == (2 if p["threads"] == 512 else 1)
    assert p["blocks_per_sm"] * p["smem"] <= SMEM_MAX - 2048
    assert (p["threads"] == 512) == (e <= 16)


@pytest.mark.parametrize("n,cluster,ok", [
    (1 << 14, 1, True), (1 << 14, 2, True), (1 << 14, 4, False),
    (1 << 15, 2, True), (1 << 15, 4, True), (1 << 15, 8, False),
    (1 << 16, 4, True), (1 << 16, 8, True), (1 << 16, 2, False),
    (1 << 16, 16, False), (1 << 17, 8, True), (1 << 17, 4, False),
    (1 << 16, 3, False), (1 << 16, 0, False)])
def test_cluster_plan_given_cluster(n, cluster, ok):
    if not ok:
        with pytest.raises(ValueError):
            cuda_cwt.cluster_plan(n, cluster)
        return
    p = cuda_cwt.cluster_plan(n, cluster)
    assert p["cluster"] == cluster and p["points"] in (8192, 16384)
    assert p["smem"] <= SMEM_MAX and p["threads"] in (512, 1024)


@pytest.mark.parametrize("n", [0, 8192, 1 << 18, 3 << 14])
def test_cluster_plan_rejects(n):
    with pytest.raises(ValueError):
        cuda_cwt.cluster_plan(n)


# the eight shape classes the on-card check runs, and a grid around them
_CLASSES = [(2048, 128, 512), (4096, 64, 1024), (512, 32, 128),
            (1024, 64, 256), (2048, 64, 2048), (128, 24, 128),
            (8192, 128, 2048), (16384, 256, 4096)]
_GRID = [(n_fft, num, slide)
         for n_fft in (16, 128, 512, 1024, 2048, 4096, 16384)
         for num in (13, 128, 1025)
         for slide in (128, n_fft // 2, n_fft)
         if slide % 128 == 0 and n_fft % slide == 0]


@pytest.mark.parametrize("n_fft,num,slide", _CLASSES + _GRID,
                         ids=lambda v: str(v))
def test_launch_shape_rules(n_fft, num, slide):
    s = _launch_shape(n_fft, num, slide)
    assert s["smem"] <= SMEM_MAX and 1 <= s["threads"] <= 1024
    tile = s["tile"]
    if s["registers"]:
        a, b, c1 = _REG_SPLIT[n_fft]
        group = b // c1
        assert a * b == n_fft and a in (group, 2 * group)
        assert group in (16, 32, 64) and s["threads"] % group == 0
        assert s["threads"] % 32 == 0 and s["threads"] <= 256
        assert tile == 2 * s["threads"] // group and not tile & (tile - 1)
        assert tile >= 4      # a filterbank thread takes four frames
        span = (tile * slide + n_fft - slide + 3) // 4 * 4
        pairs = s["threads"] // group
        ex = a * (b + 1)        # the pair's transpose buffer ...
        if a == group:          # ... and room for the rows' upper halves
            ex = max(ex, 2 * group * (b // 2 + 1))
        assert s["smem"] == 4 * (
            span + 3 * n_fft + (n_fft // 2 + 1) * (tile + 4)
            + max(pairs * ex, num * (2 * tile + 4)))
    else:
        np_ = s["np"]
        assert tile % 2 == 0 and (tile // 2) % np_ == 0
        assert s["threads"] == max(1, np_ * n_fft // 16)
        stride = n_fft + n_fft // 16 + 4
        span = (tile * slide + n_fft - slide) if s["staged"] else 0
        assert s["smem"] == 8 * stride * np_ + 4 * (2 * tile * num + span)


def test_launch_shape_routes():
    assert all(_launch_shape(n, 64, n // 4)["registers"]
               for n in (512, 1024, 2048, 4096))
    assert not any(_launch_shape(n, 64, max(128, n // 4))["registers"]
                   for n in (128, 256, 8192, 16384))
    # a bank too tall for the register kernel's rows falls to the passes
    assert _launch_shape(2048, 12500, 512)["registers"] is False


# ------------------------------------------------ cwt_ifft_bank index model

def _cwt_cluster_model(F, bank, pad, length, det, row_h, cluster):
    """``cwt_ifft_bank`` as the cluster kernel decomposes it."""
    n = F.shape[1]
    p = cuda_cwt.cluster_plan(n, cluster)
    n1, n2, ncol, nrow = p["n1"], p["n2"], p["ncol"], p["nrow"]
    points, C = p["points"], p["cluster"]
    tw = torch.view_as_complex(twiddle_table(n, torch.device("cpu")))
    out = torch.zeros((F.shape[0], bank.shape[0], length),
                      dtype=torch.complex64)
    written = torch.zeros(out.shape, dtype=torch.int32)
    idx = torch.arange(points)
    for b in range(F.shape[0]):
        for j in range(bank.shape[0]):
            h = n1 if row_h is None else min(int(row_h[j]), n1)
            # load: block c, column q, row t1 <- k = t1 * n2 + c * ncol + q
            tiles = []
            for c in range(C):
                t1 = torch.arange(n1)[:, None]
                g = t1 * n2 + c * ncol + torch.arange(ncol)[None, :]
                z = bank[j][g] * torch.conj(F[b][g])
                z = torch.where(t1 < h, z, torch.zeros_like(z))
                tiles.append(torch.fft.fft(z, dim=0))      # pass 1 over t1
            # exchange: block d, point idx -> (row k1, column t2) from peer
            for d in range(C):
                k1 = d * nrow + (idx % nrow)
                t2 = idx // nrow
                peer, q = t2 // ncol, t2 % ncol
                # the twiddle W^(k1 t2) as the kernel forms it: t2 = w + S i
                # for point i of thread tid, a product of two table values
                tid, i = idx % p["threads"], idx // p["threads"]
                w, S = tid // nrow, p["threads"] // nrow
                assert bool((t2 == w + S * i).all())
                twd = tw[(k1 * w) % n] * tw[(k1 * S * i) % n]
                y = torch.stack(tiles)[peer, k1, q] * twd
                z2 = torch.zeros((nrow, n2), dtype=torch.complex64)
                z2[idx % nrow, t2] = y
                X = torch.fft.fft(z2, dim=1)               # pass 2 over t2
                # store: pairs of rows, sample k1 + n1 * k2 - pad
                pi = torch.arange(points // 2)
                rl = (pi % (nrow // 2)) * 2
                k2 = pi // (nrow // 2)
                for e in (0, 1):
                    m = d * nrow + rl + e + k2 * n1 - pad
                    keep = (m >= 0) & (m < length)
                    v = torch.conj(X[rl + e, k2]) / n
                    if det:
                        v = v * 1j
                    out[b, j, m[keep]] = v[keep]
                    written[b, j, m[keep]] += 1
    assert bool((written == 1).all()), "a kept sample is stored exactly once"
    return out


@pytest.mark.parametrize("e,cluster", [(14, 1), (14, 2), (16, 4), (16, 8)])
@pytest.mark.parametrize("det", [False, True])
def test_cwt_cluster_index_model(e, cluster, det):
    n = 1 << e
    rng = np.random.default_rng(e + cluster)
    F = torch.from_numpy((rng.standard_normal((1, n))
                          + 1j * rng.standard_normal((1, n))
                          ).astype(np.complex64))
    bank = np.zeros((2, n), np.float32)
    bank[0, 1:n // 40] = np.abs(rng.standard_normal(n // 40 - 1))
    bank[1, 1:n // 3] = np.abs(rng.standard_normal(n // 3 - 1))
    row_h = cuda_cwt.band_row_counts(bank, n)
    bank = torch.from_numpy(bank)
    for pad, length, rows in ((n // 4, n // 2, row_h), (1001, 4321, None)):
        got = _cwt_cluster_model(F, bank, pad, length, det, rows, cluster)
        ref = cuda_cwt.cwt_ifft_bank_ref(F, bank, pad=pad, length=length,
                                         det=det)
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_cwt_cluster_model_is_the_default_split_at_every_n():
    """C = 1 at the smallest N checks the model itself; the default
    cluster of every N takes one band-row through it."""
    rng = np.random.default_rng(5)
    for e in (14, 15, 17):
        n = 1 << e
        F = torch.from_numpy((rng.standard_normal((1, n))
                              + 1j * rng.standard_normal((1, n))
                              ).astype(np.complex64))
        bank = torch.from_numpy(np.abs(rng.standard_normal((1, n))
                                       ).astype(np.float32))
        got = _cwt_cluster_model(F, bank, 0, n, False, None, None)
        ref = cuda_cwt.cwt_ifft_bank_ref(F, bank, pad=0, length=n)
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# ----------------------------------------------- fused_mel_mfcc index model

def _bit_reverse(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2)


def _fused_reg_model(plan, x):
    """``fused_mel_mfcc`` as the register-resident kernel decomposes it:
    (batch, n) audio -> mel (batch, num, T), cc (batch, cc, T)."""
    n_fft, slide = plan.n_fft, plan.slide
    A, B, C1 = _REG_SPLIT[n_fft]
    T = B // C1
    NB = n_fft // 2 + 1
    shape = _launch_shape(n_fft, plan.num_mel, slide)
    tile = shape["tile"]
    batch, n = x.shape
    n_frames = (n - n_fft) // slide + 1
    n_tiles = -(-n_frames // tile)
    tw = torch.view_as_complex(twiddle_table(n_fft, torch.device("cpu")))
    tbl = tw[(torch.arange(A)[:, None] * torch.arange(B)[None, :])]  # [k1, n2]
    win = plan.window
    lo, ln, off = (plan.band_lo.tolist(), plan.band_len.tolist(),
                   plan.band_off.tolist())
    mel = torch.zeros((batch, plan.num_mel, n_frames))
    cc = torch.zeros((batch, plan.cc_num, n_frames))
    span_cap = (tile * slide + n_fft - slide + 3) // 4 * 4
    for g in range(batch * n_tiles):
        b, t0 = g // n_tiles, (g % n_tiles) * tile
        ft = min(tile, n_frames - t0)
        span = torch.zeros(span_cap)
        s0 = t0 * slide
        got = x[b, s0:s0 + span_cap]
        span[:got.numel()] = got                      # zeros past the clip
        PS = tile + 4
        PT = torch.full((NB * PS,), float("nan"))   # bin k, frame f: k*PS+f
        for pair in range(tile // 2):
            if 2 * pair >= ft:
                continue
            sa, sb = 2 * pair * slide, (2 * pair + 1) * slide
            ex = torch.zeros(A * (B + 1), dtype=torch.complex64)
            for t in range(T):                        # first pass
                for c in range(C1):
                    n2 = t + T * c
                    i = n2 + B * torch.arange(A)
                    v = torch.complex(span[sa + i] * win[i],
                                      span[sb + i] * win[i])
                    v = torch.fft.fft(v) * tbl[:, n2]
                    ex[torch.arange(A) * (B + 1) + n2] = v
            # second pass: the rows a thread ends with, k1 and A - k1
            # (thread 0: 0 and A / 2), or k1 alone where a group is A threads
            R2 = A // T
            rows_of = {t: ((t,) if R2 == 1 else
                           (t, A // 2 if t == 0 else A - t)) for t in range(T)}
            assert sorted(k for r in rows_of.values() for k in r) == list(
                range(A))
            us = {t: [torch.fft.fft(ex[k1 * (B + 1) + torch.arange(B)])
                      for k1 in rows_of[t]] for t in range(T)}
            for t in range(T):                        # power
                u = us[t]
                for k2 in range(B // 2):
                    for s in range(R2):
                        zk = u[s][k2]
                        if t == 0:
                            zn = u[s][(B - k2) % B if s == 0 else B - 1 - k2]
                        elif R2 == 1:
                            # the upper half of thread A - t's row, which
                            # comes through the buffer
                            assert B - 1 - k2 >= B // 2
                            zn = us[(A - t) % A][0][B - 1 - k2]
                        else:
                            zn = u[1 - s][B - 1 - k2]
                        k = rows_of[t][s] + A * k2
                        ar, ai = zk.real + zn.real, zk.imag - zn.imag
                        br, bi = zk.real - zn.real, zk.imag + zn.imag
                        at = k * PS + 2 * pair
                        assert torch.isnan(PT[at]), "bin written twice"
                        PT[at] = 0.25 * (ar * ar + ai * ai)
                        PT[at + 1] = 0.25 * (br * br + bi * bi)
                if t == 0:
                    zk = us[0][0][B // 2]
                    PT[(n_fft // 2) * PS + 2 * pair] = zk.real ** 2
                    PT[(n_fft // 2) * PS + 2 * pair + 1] = zk.imag ** 2
            cols = PT.reshape(NB, PS)[:, 2 * pair:2 * pair + 2]
            assert not bool(torch.isnan(cols).any()), "a bin was not written"
        # filterbank: rounds of nthr * 4 / tile bands, odd rounds backwards
        nthr, fgn = shape["threads"], tile // 4
        bpr, done = nthr // fgn, set()
        for it, base in enumerate(range(0, plan.num_mel, bpr)):
            hi = min(plan.num_mel, base + bpr)
            for tid in range(nthr):
                ml, f0 = base + tid // fgn, (tid % fgn) * 4
                if ml >= hi or f0 >= ft:
                    continue
                m = base + hi - 1 - ml if it & 1 else ml
                assert (m, f0) not in done
                done.add((m, f0))
                rows = PT.reshape(NB, PS)[lo[m]:lo[m] + ln[m], f0:f0 + 4]
                acc = (plan.band_w[off[m]:off[m] + ln[m], None] * rows).sum(0)
                nf = min(4, ft - f0)
                mel[b, m, t0 + f0:t0 + f0 + nf] = acc[:nf]
        assert len(done) == plan.num_mel * -(-ft // 4)
        logmel = torch.log10(torch.clamp(mel[b, :, t0:t0 + ft], min=1e-8))
        cc[b, :, t0:t0 + ft] = plan.dct @ logmel
    return mel, cc


@pytest.mark.parametrize("r2e,slide,num,frames", [
    (11, 512, 128, 19),    # 64 x 32: the headline split, a ragged last tile
    (9, 128, 32, 35),      # 32 x 16: two pairs a warp
    (10, 256, 64, 3),      # 32 x 32 with two first-pass columns a thread
    (11, 2048, 64, 1),     # one frame: the pair's second frame is padding
    (12, 1024, 48, 6),     # 64 x 64: one row a thread, groups of two warps
])
def test_fused_register_index_model(r2e, slide, num, frames):
    n_fft = 1 << r2e
    sp = MelSpectrogram(num=num, samplate=32000, radix2_exp=r2e,
                        slide_length=slide, device="cpu")
    plan = FusedMelPlan(sp.window, sp.filter_bank, sp._dct[:13], slide,
                        device="cpu")
    assert _launch_shape(n_fft, num, slide)["registers"]
    rng = np.random.default_rng(r2e)
    x = torch.from_numpy((rng.standard_normal(
        (2, (frames - 1) * slide + n_fft + 5)) * 0.2).astype(np.float32))
    mel, cc = _fused_reg_model(plan, x)
    mel_r, cc_r = fused_mel_mfcc_ref(plan, x)
    assert mel.shape == mel_r.shape and cc.shape == cc_r.shape
    assert float((mel - mel_r).abs().max()) <= 1e-5 * float(mel_r.abs().max())
    assert float((cc - cc_r).abs().max()) <= 1e-5 * float(cc_r.abs().max())


def test_fused_register_index_model_dense_bank_and_jax():
    """A dense (all-nonzero) filterbank through the model, and the model
    against the JAX package's exact mel spectrogram as
    tests/test_torch_fused_mel.py holds the wrapper to it."""
    rng = np.random.default_rng(1)
    j = JMel(num=32, samplate=32000, radix2_exp=9, slide_length=128)
    x = (rng.standard_normal((1, 6 * 128 + 512)) * 0.2).astype(np.float32)
    plan = FusedMelPlan(j.window, j.filter_bank, j._dct[:5], 128,
                        device="cpu")
    mel, _ = _fused_reg_model(plan, torch.from_numpy(x))
    want = np.asarray(j.spectrogram(x))
    assert np.abs(mel.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    fb = (np.abs(rng.standard_normal((32, 257))) + 0.01).astype(np.float32)
    dense = FusedMelPlan(j.window, fb, j._dct[:5], 128, device="cpu")
    assert dense.band_nnz == fb.size
    mel, cc = _fused_reg_model(dense, torch.from_numpy(x))
    mel_r, cc_r = fused_mel_mfcc_ref(dense, torch.from_numpy(x))
    assert float((mel - mel_r).abs().max()) <= 1e-5 * float(mel_r.abs().max())
    assert float((cc - cc_r).abs().max()) <= 1e-5 * float(cc_r.abs().max())


def test_register_dft_bit_reversal_is_a_permutation():
    """The kernels load point j into register bit_reverse(j): the loopless
    form of csrc/fft_reg.cuh, mirrored."""
    def rev8(x, bits):
        x = ((x & 0xF0) >> 4) | ((x & 0x0F) << 4)
        x = ((x & 0xCC) >> 2) | ((x & 0x33) << 2)
        x = ((x & 0xAA) >> 1) | ((x & 0x55) << 1)
        return x >> (8 - bits)
    for bits in (4, 5, 6):
        got = [rev8(j, bits) for j in range(1 << bits)]
        assert got == [_bit_reverse(j, bits) for j in range(1 << bits)]
        assert sorted(got) == list(range(1 << bits))
    assert fused_mel._REG_SPLIT[2048] == (64, 32, 1)


# ------------------------------------------- fft_pow2 register-route model

_FFT_SPLIT = {2048: (64, 32), 4096: (64, 64)}   # csrc/fft_pow2.cu launch_reg


def _fft_reg_model(xr, xi=None, inverse=False):
    """``fft_reg_kernel`` as it decomposes the rows: (batch, n) -> (re,
    im), each bin written exactly once."""
    batch, n = xr.shape
    A, B = _FFT_SPLIT[n]
    T = B                                   # a thread a first-pass column
    R2 = A // T
    sign, scale = (-1.0, 1.0 / n) if inverse else (1.0, 1.0)
    real = xi is None and not inverse       # real rows in pairs (reg_pairs)
    tw = torch.view_as_complex(twiddle_table(n, torch.device("cpu")))
    tbl = tw[torch.arange(A)[:, None] * torch.arange(B)[None, :]].numpy()
    x = xr.numpy().astype(np.float64)
    yr = np.full((batch, n), np.nan)
    yi = np.full((batch, n), np.nan)
    items = (batch + 1) // 2 if real else batch
    for q in range(items):
        ra = 2 * q if real else q
        has_b = real and ra + 1 < batch
        a = x[ra]
        if real:
            b = x[ra + 1] if has_b else np.zeros(n)
        else:
            b = np.zeros(n) if xi is None else xi.numpy()[q].astype(np.float64)
        # first pass: thread t, column n2 = t, points t + B j
        ex = np.zeros((A, B), dtype=complex)
        for t in range(T):
            i = t + B * np.arange(A)
            ex[:, t] = np.fft.fft(a[i] + 1j * sign * b[i]) * tbl[:, t]
        rows_of = {t: (t,) if R2 == 1 else (t, A // 2 if t == 0 else A - t)
                   for t in range(T)}
        assert sorted(k for r in rows_of.values() for k in r) == list(
            range(A))
        u = {t: [np.fft.fft(ex[k1]) for k1 in rows_of[t]] for t in range(T)}

        def put(row, k, z):
            assert np.isnan(yr[row, k]), "bin written twice"
            yr[row, k], yi[row, k] = z.real, z.imag
        if not real:
            for t in range(T):
                for s, k1 in enumerate(rows_of[t]):
                    for k2 in range(B):
                        z = u[t][s][k2]
                        put(ra, k1 + A * k2,
                            complex(scale * z.real, sign * scale * z.imag))
            continue
        for t in range(T):
            for k2 in range(B // 2):
                for s in range(R2):
                    zk = u[t][s][k2]
                    if t == 0:
                        zn = u[0][s][(B - k2) % B if s == 0 else B - 1 - k2]
                    elif R2 == 1:
                        # the upper half of thread A - t's row, which
                        # comes through the buffer
                        assert B - 1 - k2 >= B // 2
                        zn = u[(A - t) % A][0][B - 1 - k2]
                    else:
                        zn = u[t][1 - s][B - 1 - k2]
                    za = (zk + np.conj(zn)) / 2
                    zb = (zk - np.conj(zn)) / 2j
                    k = rows_of[t][s] + A * k2
                    km = (n - k) % n
                    for row, z in ((ra, za), (ra + 1, zb)):
                        if row == ra or has_b:
                            put(row, k, z)
                            if km != k:
                                put(row, km, np.conj(z))
            if t == 0:
                zk = u[0][0][B // 2]
                put(ra, n // 2, complex(zk.real, 0.0))
                if has_b:
                    put(ra + 1, n // 2, complex(zk.imag, 0.0))
    assert not np.isnan(yr).any() and not np.isnan(yi).any()
    return torch.from_numpy(yr), torch.from_numpy(yi)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("form", ["real", "complex", "inverse",
                                  "real inverse"])
def test_fft_register_index_model(n, batch, form):
    """Real rows in pairs (batch 3: the last row alone, b = 0; batch 1:
    one row), complex rows, and the inverse with its conjugations and 1/n,
    of a complex spectrum and of a real one (a null imaginary input: one
    row a transform, never paired), against the plain versions on the
    CPU."""
    rng = np.random.default_rng(n + batch)
    xr = torch.from_numpy(rng.standard_normal((batch, n)).astype(np.float32))
    xi = torch.from_numpy(rng.standard_normal((batch, n)).astype(np.float32))
    if form == "real":
        got, ref = _fft_reg_model(xr), fft_fwd_ref(xr)
    elif form == "complex":
        got, ref = _fft_reg_model(xr, xi), fft_fwd_ref(xr, xi)
    elif form == "inverse":
        got, ref = _fft_reg_model(xr, xi, inverse=True), fft_inv_ref(xr, xi)
    else:
        got = _fft_reg_model(xr, inverse=True)
        ref = fft_inv_ref(xr, torch.zeros_like(xr))
    peak = float(torch.sqrt(ref[0].double() ** 2 + ref[1].double() ** 2).max())
    for g, r in zip(got, ref):
        assert float((g - r.double()).abs().max()) <= 1e-6 * peak
