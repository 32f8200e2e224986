"""The autocorrelation's register route (``csrc/fft_pow2.cu``
``autocorr_reg_kernel``) as an index model in plain PyTorch and numpy, and
YIN's entry ``fft_autocorr_yin`` against the JAX package.

The CUDA kernel cannot run without the card, so what can go wrong in it
before any arithmetic does — which thread holds which point and bin, the
order of the inverse's passes, the padded twiddle table, the lags kept —
is mirrored here with the kernel's own index formulas and held against
``fft_autocorr_ref`` at 1e-5 of the peak (the models use float64
sub-transforms; the kernel's contract on the card is 5e-5).  YIN's plain
version is held against the JAX package's autocorrelation through the
Pallas ``fft4_autocorr`` in interpret mode at 5e-5 of the peak, that
kernel's contract.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from audioflux_tpu.ops import pallas_fft as pfft
from audioflux_tpu.ops.frame import frame_signal as j_frame_signal
from audioflux_torch.ops import _build, cuda_fft
from audioflux_torch.ops.cuda_fft import (fft_autocorr_ref,
                                          fft_autocorr_yin,
                                          fft_autocorr_yin_ref, twiddle_table)

_SPLIT = {2048: (64, 32), 4096: (64, 64)}   # csrc/fft_pow2.cu launch_acf


def _bit_reverse(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2)


def _acf_model(rows, n, lag=None):
    """``autocorr_reg_kernel`` on ``rows``: a list of (a, b) pairs of n
    points (the general entry) or, with ``lag``, of staged frames (YIN:
    b[j] = a[lag - j] for j <= lag, and only lags >= lag are written).
    Returns one output row an item, each point written exactly once."""
    A, B = _SPLIT[n]
    T, P = B, B + 1
    R2 = A // T
    tw = torch.view_as_complex(twiddle_table(n, torch.device("cpu")))
    tw = tw.numpy().astype(np.complex128)
    # the table in rows of B + 1: W_n^(c k1) at [k1 * P + c], 0 at c = B
    tbl = np.zeros(A * P, dtype=complex)
    for i in range(A * P):
        k1, c = divmod(i, P)
        tbl[i] = tw[k1 * c] if c < B else 0
    # bank of a word of the table as a thread reads it: the forward reads
    # [k1 * P + t] (consecutive t), the inverse [k1r * P + j2]; each 8-byte
    # word of a half warp falls in its own pair of banks
    for t_set in (np.arange(16), np.arange(16, 32)):
        for k1r in (t_set, (A - t_set) % A):
            banks = (2 * (k1r * P + 5)) % 32
            assert len(set(banks.tolist())) == 16
    rows_of = {t: (t,) if R2 == 1 else (t, A // 2 if t == 0 else A - t)
               for t in range(T)}
    assert sorted(k for r in rows_of.values() for k in r) == list(range(A))
    lo = 0 if lag is None else lag
    out = []
    for a, b in rows:
        stage = a.astype(np.float64)
        if lag is None:
            im = b.astype(np.float64)
        else:
            im = np.array([stage[lag - i] if i <= lag else 0.0
                           for i in range(n)])
        # forward, first pass: thread t, column t, points t + B j, loaded
        # in bit-reversed order (reg_dft's input order)
        ex = np.zeros((A, P), dtype=complex)
        for t in range(T):
            i = t + B * np.arange(A)
            v = np.empty(A, dtype=complex)
            for j in range(A):
                v[_bit_reverse(j, int(np.log2(A)))] = stage[i[j]] + 1j * im[i[j]]
            v = np.fft.fft(v[[_bit_reverse(j, int(np.log2(A)))
                              for j in range(A)]])
            v = v * tbl[np.arange(A) * P + t]     # k1 = 0 has weight 1
            ex[:, t] = v
        # the transpose: thread t takes its rows; the B-point DFT over n2
        # gives bin k1 + A k2 at u[s][k2]; the square, conjugated; the
        # B-point DFT over k2; the twiddle W_n^(k1 j2) from the table's row
        H = np.zeros((A, B), dtype=complex)
        for t in range(T):
            for k1 in rows_of[t]:
                Z = np.fft.fft(ex[k1, :B])
                S = np.conj(Z * Z)
                G = np.fft.fft(S)
                H[k1] = G * tbl[k1 * P + np.arange(B)]
        # the transpose back: column t of every row; the A-point DFT over
        # k1 gives F[t + B j1]; out = -0.5 / n Im(F) at lags >= lo
        row = np.full(n - lo, np.nan)
        for t in range(T):
            F = np.fft.fft(H[:, t])
            for j1 in range(A):
                i = t + B * j1
                if i >= lo:
                    assert np.isnan(row[i - lo]), "a lag written twice"
                    row[i - lo] = -0.5 / n * F[j1].imag
        assert not np.isnan(row).any()
        out.append(row)
    return np.stack(out)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("batch", [1, 3])
def test_autocorr_register_index_model(n, batch):
    """The general entry (xr, xi rows) against ``fft_autocorr_ref``."""
    rng = np.random.default_rng(n + batch)
    xr = rng.standard_normal((batch, n)).astype(np.float32)
    xi = rng.standard_normal((batch, n)).astype(np.float32)
    got = _acf_model(list(zip(xr, xi)), n)
    ref = fft_autocorr_ref(torch.from_numpy(xr), torch.from_numpy(xi))
    ref = ref.double().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n,slide,lag", [(2048, 512, 1024),
                                         (4096, 1024, 2048),
                                         (2048, 1001, 1001),
                                         (4096, 777, 0)])
def test_autocorr_yin_index_model(n, slide, lag):
    """YIN's entry: item q is frame q % frames of clip q / frames, staged
    from the clip; z from the staged frame and its reversed prefix; only
    lags >= auto_length written.  Against ``fft_autocorr_yin_ref`` on two
    clips whose length is no multiple of the slide."""
    rng = np.random.default_rng(n + lag)
    x = rng.standard_normal((2, n + 2 * slide + 37)).astype(np.float32)
    frames = (x.shape[1] - n) // slide + 1
    items = [(x[q // frames, (q % frames) * slide:][:n], None)
             for q in range(2 * frames)]
    got = _acf_model(items, n, lag=lag).reshape(2, frames, n - lag)
    ref = fft_autocorr_yin_ref(torch.from_numpy(x), n, slide, lag)
    assert ref.shape == (2, frames, n - lag)
    ref = ref.double().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _jax_yin_acf(x, n, slide, lag):
    """The JAX package's YIN autocorrelation (``mir/pitch_yin.py``
    ``_yin_impl``, packed form with its fused kernel): the frames, the
    reversed prefix padded to n, ``fft4_autocorr`` in interpret mode, the
    lags from auto_length."""
    frames = j_frame_signal(jnp.asarray(x), n, slide)
    rev = jnp.flip(frames[..., :lag + 1], axis=-1)
    rev = jnp.pad(rev, [(0, 0)] * (rev.ndim - 1) + [(0, n - rev.shape[-1])])
    return np.asarray(pfft.fft4_autocorr(frames, rev, interpret=True))[
        ..., lag:]


@pytest.mark.parametrize("shape,slide", [((2, 2048 + 3 * 512 + 301), 512),
                                         ((2048 + 100,), 512),
                                         ((1, 2048), 1024)])
def test_autocorr_yin_matches_pallas_interpret(shape, slide):
    """radix2_exp 11, auto_length 1024: clips whose length is no multiple
    of the slide, and clips of a single frame; 5e-5 of the peak."""
    n, lag = 2048, 1024
    x = (0.5 * np.random.default_rng(len(shape) + slide)
         .standard_normal(shape)).astype(np.float32)
    want = _jax_yin_acf(x, n, slide, lag)
    for fn in (fft_autocorr_yin_ref, fft_autocorr_yin):
        got = fn(torch.from_numpy(x), n, slide, lag).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 5e-5 * np.abs(want).max()
    frames = (shape[-1] - n) // slide + 1
    assert want.shape == shape[:-1] + (frames, n - lag)


def test_autocorr_yin_cpu_policy_and_checks(monkeypatch):
    """A CPU tensor takes the plain version and never builds; the entry's
    domain is the register route's lengths."""
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 5000)).astype(np.float32))
    before = fft_autocorr_yin.launches
    got = fft_autocorr_yin(x, 2048, 512, 1024)
    assert torch.equal(got, fft_autocorr_yin_ref(x, 2048, 512, 1024))
    assert got.shape == (3, 6, 1024) and got.is_contiguous()
    assert fft_autocorr_yin.launches == before
    assert set(cuda_fft.REGISTER_N) == set(_SPLIT)
    for args in ((x, 1024, 256, 512), (x, 2048, 512, 2048),
                 (x, 2048, 0, 1024), (x[:, :2000], 2048, 512, 1024)):
        with pytest.raises(ValueError):
            fft_autocorr_yin(*args)
    with pytest.raises(TypeError):
        fft_autocorr_yin(x.double(), 2048, 512, 1024)
