"""The port's CWT filterbank-convolution wrapper on the CPU (its plain
version) against the JAX package's fused Pallas kernel in interpret mode,
plus the host-side support-row count and the domain gate."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from audioflux_tpu.ops import pallas_cwt as jpc
from audioflux_tpu.transforms.cwt import CWT as JCWT
from audioflux_tpu.transforms.pwt import PWT as JPWT
from audioflux_torch.ops import _build, cuda_cwt

N, LENGTH = 16384, 8192      # the smallest N the kernels take
PAD = LENGTH // 2


def _graded_case(seed=2):
    """B = 2 spectra and a 6-band analytic-style bank: contiguous bumps
    [1, hi_j] of growing width, so the support rows differ per band."""
    rng = np.random.default_rng(seed)
    F = (rng.standard_normal((2, N))
         + 1j * rng.standard_normal((2, N))).astype(np.complex64)
    bank = np.zeros((6, N), np.float32)
    for j, hi in enumerate([40, 300, 700, 1500, 3000, 6000]):
        bank[j, 1:hi] = np.abs(rng.standard_normal(hi - 1))
    return F, bank


@pytest.mark.parametrize("det", [False, True])
@pytest.mark.parametrize("with_rows", [False, True])
def test_ref_matches_pallas_interpret(det, with_rows):
    """<= 2e-5 of the peak: the JAX kernel's own bound against a float64
    inverse FFT (tests/test_pallas_cwt.py), its bf16x3 products being the
    larger error of the two."""
    F, bank = _graded_case()
    row_h = jpc.band_row_counts(bank, N) if with_rows else None
    want = np.asarray(jpc.cwt_ifft_bank(
        jnp.asarray(F), jnp.asarray(bank), pad=PAD, length=LENGTH, det=det,
        row_h=row_h, interpret=True))
    rows_t = (None if row_h is None
              else torch.tensor(row_h, dtype=torch.int32))
    got = cuda_cwt.cwt_ifft_bank(torch.from_numpy(F), torch.from_numpy(bank),
                                 pad=PAD, length=LENGTH, det=det,
                                 row_h=rows_t).numpy()
    assert got.shape == want.shape == (2, 6, LENGTH)
    assert got.dtype == np.complex64
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()
    # and against float64 numpy, where the plain version is fp32-accurate
    exact = np.fft.ifft(bank[None].astype(np.float64) * F[:, None, :],
                        axis=-1)[..., PAD:PAD + LENGTH] * (1j if det else 1)
    assert np.abs(got - exact).max() <= 2e-6 * np.abs(exact).max()


def test_ref_odd_slice():
    """The port's kernels take any pad + length <= N (the JAX gate wants R
    to divide both): the plain version at an odd slice."""
    F, bank = _graded_case(3)
    got = cuda_cwt.cwt_ifft_bank_ref(torch.from_numpy(F),
                                     torch.from_numpy(bank), pad=1000,
                                     length=4321).numpy()
    exact = np.fft.ifft(bank[None].astype(np.float64) * F[:, None, :],
                        axis=-1)[..., 1000:5321]
    assert got.shape == (2, 6, 4321)
    assert np.abs(got - exact).max() <= 2e-6 * np.abs(exact).max()


@pytest.mark.parametrize("bank_kind", ["graded", "dense", "empty_band",
                                       "cwt_morlet", "cwt_det", "pwt_mel"])
def test_band_row_counts_equal_jax(bank_kind):
    if bank_kind == "graded":
        bank, n = _graded_case()[1], N
    elif bank_kind == "dense":
        bank = np.abs(np.random.default_rng(0).standard_normal((3, N))
                      ).astype(np.float32)
        n = N
    elif bank_kind == "empty_band":
        bank, n = _graded_case()[1].copy(), N
        bank[2] = 0
        bank[4, :] = 0
        bank[4, 9000] = 1.0        # support that is not a leading run
    elif bank_kind in ("cwt_morlet", "cwt_det"):
        plan = JCWT(num=40, radix2_exp=14, wavelet_type=1)   # N = 32768
        plan.enable_det(True)
        bank = plan._bank if bank_kind == "cwt_morlet" else plan._det_bank
        n = bank.shape[1]
    else:
        plan = JPWT(num=32, radix2_exp=13, scale_type=2)     # N = 16384
        bank, n = plan._bank, plan._bank.shape[1]
    want = jpc.band_row_counts(bank, n)
    got = cuda_cwt.band_row_counts(bank, n)
    assert got == want
    assert all(isinstance(v, int) and v % 8 == 0 for v in got)


def test_supports_gate():
    assert not cuda_cwt.supports(8192, 2048, 4096)        # below the floor
    assert not cuda_cwt.supports(16384 + 4, 8192, 8192)   # not a power of two
    assert cuda_cwt.supports(65536, 16384, 32768)         # CWT at radix2_exp 15
    assert cuda_cwt.supports(131072, 32768, 65536)
    assert not cuda_cwt.supports(1 << 18, 0, 1 << 18)     # above the ceiling
    assert cuda_cwt.supports(16384, 1000, 4321)           # any slice inside N
    assert not cuda_cwt.supports(16384, 9000, 8192)       # slice past N
    # every shape the JAX kernel takes, the port's takes too
    for n, p, ln in ((16384, 4096, 8192), (32768, 8192, 16384),
                     (65536, 16384, 32768), (16384, 0, 16384)):
        assert jpc.supports(n, p, ln) and cuda_cwt.supports(n, p, ln)


def test_cpu_tensor_runs_plain_version_without_a_build(monkeypatch):
    """A CPU tensor takes the plain version: no build, no launch, no
    count."""
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build or load a kernel")
    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    F, bank = _graded_case()
    before = cuda_cwt.cwt_ifft_bank.launches
    got = cuda_cwt.cwt_ifft_bank(torch.from_numpy(F), torch.from_numpy(bank),
                                 pad=PAD, length=LENGTH)
    want = cuda_cwt.cwt_ifft_bank_ref(torch.from_numpy(F),
                                      torch.from_numpy(bank), pad=PAD,
                                      length=LENGTH)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    assert cuda_cwt.cwt_ifft_bank.launches == before


@pytest.mark.parametrize("bad", ["dtype_F", "dtype_bank", "shape", "domain"])
def test_wrapper_refuses(bad):
    F, bank = _graded_case()
    F, bank = torch.from_numpy(F), torch.from_numpy(bank)
    kw = dict(pad=PAD, length=LENGTH)
    if bad == "dtype_F":
        with pytest.raises(TypeError):
            cuda_cwt.cwt_ifft_bank(F.to(torch.complex128), bank, **kw)
    elif bad == "dtype_bank":
        with pytest.raises(TypeError):
            cuda_cwt.cwt_ifft_bank(F, bank.double(), **kw)
    elif bad == "shape":
        with pytest.raises(ValueError):
            cuda_cwt.cwt_ifft_bank(F[:, :8192], bank, **kw)
    else:
        with pytest.raises(ValueError):
            cuda_cwt.cwt_ifft_bank(F, bank, pad=PAD, length=N)


def test_wrapper_has_no_chunk_and_no_scratch():
    """One cluster launch, no device scratch: the ``chunk=`` knob and the
    scratch buffer are gone, and the public signature is the rest."""
    import inspect
    sig = inspect.signature(cuda_cwt.cwt_ifft_bank)
    assert list(sig.parameters) == ["F", "bank", "pad", "length", "det",
                                    "row_h"]
    assert not hasattr(cuda_cwt, "_SCRATCH_BYTES")
    assert list(inspect.signature(cuda_cwt.cwt_ifft_bank_ref).parameters) == [
        "F", "bank", "pad", "length", "det"]


@pytest.mark.parametrize("n", [1 << 14, 1 << 15, 1 << 16, 1 << 17])
def test_cluster_plan_matches_band_row_counts_split(n):
    """The kernel's (n1, n2) view is the one ``band_row_counts`` counts
    rows of, so a support count is a number of rows t1 of pass 1."""
    plan = cuda_cwt.cluster_plan(n)
    bank = np.zeros((2, n), np.float32)
    bank[0, 1:3 * plan["n2"] + 5] = 1.0      # reaches into row 3
    bank[1, :] = 1.0
    rows = cuda_cwt.band_row_counts(bank, n)
    assert rows == (8, plan["n1"])
    assert plan["n1"] == np.asarray(jpc.band_row_counts(bank, n)).max()


def test_supports_is_the_kernels_domain():
    for n in (1 << 14, 1 << 15, 1 << 16, 1 << 17):
        assert cuda_cwt.supports(n, 0, n) and cuda_cwt.supports(n, 5, 7)
        assert cuda_cwt.cluster_plan(n)["cluster"] <= 8
    for n in (1 << 13, 1 << 18, 3 << 14):
        assert not cuda_cwt.supports(n, 0, 16)
        with pytest.raises(ValueError):
            cuda_cwt.cluster_plan(n)
    assert not cuda_cwt.supports(1 << 14, 1, 1 << 14)
