"""Complex rows at n = 8192 and 16384 (``csrc/fft_pow2.cu``
``row_reg_kernel``, the row route of ``cuda_fft.fft_fwd``/``fft_inv``) as a
numpy float64 model of the kernel's own indices, and the port's plain
versions on the CPU against the JAX package's kernels in interpret mode.

The kernel runs the real-row route's register transform on all n points
(``csrc/fft_real_reg.cuh`` at N = n = 4096 C, C = 2, 4; the model of
``tests/test_torch_autocorr_regs.py``): B = 64 C threads a row, thread t
reads its points j = j1 B + t of the two staged planes (the real plane
at [0, n), the imaginary one at [n + 8, 2 n + 8); a null imaginary input
is that plane left at zero) into v[bitrev(j1)], the inverse with the
imaginary part's sign turned.  The transform leaves Z[g + 64 ka + 4096
kb] with thread u = g C + jb at v[ka] (kb = bitrev(jb)), and the thread
stores it at that bin of yr and yi straight from registers, times 1 or
(the inverse, conjugated) 1/n.  For a fixed ka the 32 lanes of a warp
write 32 / C consecutive bins at each of C offsets 4096 apart: whole
32-byte sectors.  The measurement variant writes each plane into the
transpose buffer at slot(k) = k + (k >> 12) 32 / C and reads it back as
16-byte words."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from audioflux_tpu.ops import pallas_fft as pfft
from audioflux_torch.ops import cuda_fft
from tests.test_torch_autocorr_regs import bins_of, factors, forward, lanes

TOL = 5e-5          # the TPU kernel's contract, of the peak
MODEL_TOL = 1e-6    # the model (fp32 twiddles, float64 arithmetic), of
                    # the peak
LENGTHS = (8192, 16384)


def _rel(got, ref):
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _rows(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bitrev6(x):
    return int(f"{x:06b}"[::-1], 2)


def staged_load(xr, xi, inverse):
    """The staging buffer of one row and thread t's loads: v[bitrev(j1),
    t] = (stage[j], sign * stage[n + 8 + j]), j = j1 B + t.  Returns the
    (64, B) complex registers and how often each word of the buffer was
    read."""
    n = xr.size
    B = n // 64
    imag = n + 8
    stage = np.full(2 * imag, np.nan)
    stage[:n] = xr
    stage[imag:imag + n] = 0.0 if xi is None else xi
    reads = np.zeros(stage.size, int)
    v = np.empty((64, B), dtype=complex)
    t = np.arange(B)
    sign = -1.0 if inverse else 1.0
    for j1 in range(64):
        j = j1 * B + t
        np.add.at(reads, j, 1)
        np.add.at(reads, imag + j, 1)
        v[_bitrev6(j1), t] = stage[j] + 1j * sign * stage[imag + j]
    assert not np.isnan(v).any(), "a load outside the staged planes"
    return v, reads


def row_model(xr, xi, inverse=False):
    """row_reg_kernel on one row: (yr, yi) written by the stores, and the
    count of writes of each bin."""
    n = xr.size
    B = n // 64
    v, reads = staged_load(xr, xi, inverse)
    # the registers hold z[j1 B + t] at v[bitrev(j1)]: the transform's
    # input in natural order
    z = np.empty(n, dtype=complex)
    slot = [_bitrev6(j1) for j1 in range(64)]
    z[:] = v[slot].reshape(-1)
    out = forward(z, factors(n, n))                    # v[ka, u]
    scale = np.float32(1.0 / n) if inverse else 1.0
    sign = -1.0 if inverse else 1.0
    addr = bins_of(n)                                  # g + 64 ka + 4096 kb
    yr = np.full(n, np.nan)
    yi = np.full(n, np.nan)
    writes = np.zeros(n, int)
    np.add.at(writes, addr.reshape(-1), 1)
    yr[addr] = scale * out.real
    yi[addr] = sign * scale * out.imag
    return yr, yi, writes, reads


@pytest.mark.parametrize("n", LENGTHS)
def test_loads_read_each_staged_point_once(n):
    """Every point of both staged planes is read once, nothing else is:
    the 8 floats after each plane are never touched."""
    xr, xi = _rows((2, n), n)
    _, reads = staged_load(xr, xi, False)
    imag = n + 8
    planes = np.zeros(reads.size, bool)
    planes[:n] = planes[imag:imag + n] = True
    assert (reads[planes] == 1).all() and (reads[~planes] == 0).all()


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("inverse", [False, True])
def test_row_model_is_the_fft(n, inverse):
    """The whole row through the model's loads, transform and stores
    against ``np.fft.fft`` (the forward) or ``np.fft.ifft`` (the inverse:
    the conjugated forward with 1/n) at MODEL_TOL of the peak; each bin
    written once."""
    rng = np.random.default_rng(n + inverse)
    xr, xi = rng.standard_normal((2, n))
    yr, yi, writes, _ = row_model(xr, xi, inverse)
    assert (writes == 1).all()
    ref = (np.fft.ifft if inverse else np.fft.fft)(xr + 1j * xi)
    assert _rel(yr + 1j * yi, ref) <= MODEL_TOL


@pytest.mark.parametrize("n", LENGTHS)
def test_null_imaginary_input_is_a_zero_plane(n):
    """The C entry's inverse of a spectrum with no imaginary part: the
    zero plane the kernel stages once gives ``ifft`` of the real spectrum."""
    xr = np.random.default_rng(n + 7).standard_normal(n)
    yr, yi, _, _ = row_model(xr, None, inverse=True)
    assert _rel(yr + 1j * yi, np.fft.ifft(xr)) <= MODEL_TOL


@pytest.mark.parametrize("n", LENGTHS)
def test_register_stores_fill_whole_sectors(n):
    """For each ka, the 32 lanes of each warp store 32 distinct bins that
    make up whole 32-byte sectors (8 floats) of a row, 32 / C consecutive
    bins at each of the C offsets."""
    C, B, P, g, jb, kb = lanes(n)
    addr = bins_of(n)                                  # [ka, u]
    for ka in range(64):
        for w in range(B // 32):
            a = np.sort(addr[ka, 32 * w:32 * w + 32])
            assert len(set(a.tolist())) == 32
            sectors = set((a // 8).tolist())
            assert len(sectors) * 8 == 32, "a sector partly written"
            runs = np.split(a, np.nonzero(np.diff(a) != 1)[0] + 1)
            assert len(runs) == C and all(r.size == 32 // C for r in runs)


@pytest.mark.parametrize("n", LENGTHS)
def test_buffer_store_slots(n):
    """The measurement variant's slots: every bin its own word inside the
    transpose buffer (64 rows of B + C floats), the lanes of a warp on 32
    distinct banks for each ka, and each 16-byte word read back holds
    four consecutive bins."""
    C, B, P, g, jb, kb = lanes(n)
    skew = 32 // C

    def slot(k):
        return k + (k >> 12) * skew
    addr = bins_of(n)
    s = slot(addr)
    assert len(set(s.reshape(-1).tolist())) == n
    assert s.max() < 64 * P
    for ka in range(64):
        for w in range(B // 32):
            banks = s[ka, 32 * w:32 * w + 32] % 32
            assert len(set(banks.tolist())) == 32
    i = np.arange(0, n, 4)
    assert (slot(i + 3) - slot(i) == 3).all() and (slot(i) % 4 == 0).all()


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("out_imag", [True, False])
def test_plain_versions_match_jax_kernels(n, out_imag):
    """``fft_fwd``/``fft_inv`` on complex rows at 8192 and 16384 (the plain
    versions on the CPU) against ``fft4_fwd``/``fft4_inv`` in interpret
    mode at 5e-5 of the peak, the inverse with and without its imaginary
    output; they reach no kernel."""
    xr, xi = _rows((2, 2, 3, n), n + out_imag)
    yr, yi = cuda_fft.fft_fwd(torch.from_numpy(xr), torch.from_numpy(xi))
    jr, ji = pfft.fft4_fwd(jnp.asarray(xr), jnp.asarray(xi), interpret=True)
    ref = (np.asarray(pfft.t_to_natural(jr))
           + 1j * np.asarray(pfft.t_to_natural(ji)))
    assert _rel(yr.numpy() + 1j * yi.numpy(), ref) <= TOL
    br, bi = cuda_fft.fft_inv(yr, yi, out_imag=out_imag)
    assert (bi is None) != out_imag
    n1 = n // 128
    jr, ji = pfft.fft4_inv(pfft.natural_to_t(jnp.asarray(yr.numpy()), n1),
                           pfft.natural_to_t(jnp.asarray(yi.numpy()), n1),
                           out_imag=out_imag, interpret=True)
    assert _rel(br.numpy(), np.asarray(jr)) <= TOL
    if out_imag:
        assert _rel(bi.numpy(), np.asarray(ji)) <= TOL
    assert cuda_fft.fft_fwd.row_launches == 0
    assert cuda_fft.fft_inv.row_launches == 0


@pytest.mark.parametrize("n", LENGTHS)
def test_plain_inverse_of_a_real_spectrum_matches_jax_kernel(n):
    """``fft_inv`` of a spectrum whose imaginary part is zero (the C
    entry's null imaginary input) against ``fft4_inv`` in interpret mode
    at 5e-5 of the peak, both outputs."""
    yr = _rows((2, 3, n), n + 5)
    yi = np.zeros_like(yr)
    br, bi = cuda_fft.fft_inv(torch.from_numpy(yr), torch.from_numpy(yi))
    n1 = n // 128
    jr, ji = pfft.fft4_inv(pfft.natural_to_t(jnp.asarray(yr), n1),
                           pfft.natural_to_t(jnp.asarray(yi), n1),
                           interpret=True)
    assert _rel(br.numpy(), np.asarray(jr)) <= TOL
    assert _rel(bi.numpy(), np.asarray(ji)) <= TOL


def test_row_route():
    """Complex rows at 8192 and 16384 take the row route; real rows the
    real-row route, 32768 the clusters."""
    assert [cuda_fft.route(n, False) for n in (8192, 16384, 32768)] == [
        "row", "row", "cluster"]
    assert all(cuda_fft.route(n, True) == "real" for n in LENGTHS)
