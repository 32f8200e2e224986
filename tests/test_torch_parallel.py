"""The port's mesh and its halo-sharded mel, STFT/ISTFT and spectral
statistics on the CPU, against the JAX package's sharded functions on the
same mesh shape (conftest's 8 virtual devices; the fused form in interpret
mode with ``fused_tile=8``) and against the port's own unsharded calls.

Tolerances: 1e-4 of the peak against the JAX package (the port's slice-1
gate for mel and STFT); the STFT frames ``torch.equal`` to the port's
unsharded ``STFT.stft`` (each frame is one row of one FFT, whatever the
shard).  The sharded mel is held to the port's unsharded one at 1e-6 of
the peak, not for equality: its filterbank product runs per shard, and a
matrix product's blocking (and so its rounding) depends on how many frames
it holds."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.ops.window import get_fft_window as j_window
from audioflux_tpu.parallel import make_mesh as j_make_mesh
from audioflux_tpu.parallel import sharded as j_sharded
from audioflux_tpu.parallel.features import sharded_spectral_stats_fn as j_stats
from audioflux_torch.parallel import _shard
from audioflux_torch.parallel import make_mesh
from audioflux_torch.parallel.features import sharded_spectral_stats_fn
from audioflux_torch.parallel.sharded import (sharded_istft_fn,
                                              sharded_spectrogram_fn,
                                              sharded_stft_fn, valid_frames)
from audioflux_torch.types import WindowType

FFT, SLIDE, SR = 2048, 512, 32000
CPU8 = [torch.device("cpu")] * 8


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(data=2, time=4, devices=CPU8)


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(data=2, time=4)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((4, 32768)) * 0.2).astype(np.float32)


def _plans(**kw):
    kw = dict(num=128, samplate=SR, radix2_exp=11, slide_length=SLIDE, **kw)
    return af.MelSpectrogram(**kw), aft.MelSpectrogram(**kw, device="cpu")


# --- the mesh ---------------------------------------------------------------

def test_make_mesh_shape_and_devices():
    m = make_mesh(data=2, time=4, devices=CPU8)
    assert m.shape == {"data": 2, "time": 4}
    assert m.axis_names == ("data", "time")
    assert m.devices.shape == (2, 4) and m.first == torch.device("cpu")
    assert m.grid("time", "data").shape == (4, 2)


def test_make_mesh_raises_without_cuda_or_devices():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(data=1, time=1)
    with pytest.raises(ValueError, match="need 8 devices"):
        make_mesh(data=2, time=4, devices=CPU8[:3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(data=1, time=1, devices=[torch.device("cuda")])


def test_replica_uploads_constants_again(monkeypatch, batch):
    """A plan's copy for another device re-uploads its constants and gives
    the same result (forced here on the CPU by declaring the devices
    different)."""
    _, plan = _plans()
    monkeypatch.setattr(_shard, "_same", lambda a, b: False)
    rep = _shard.replica(plan, torch.device("cpu"))
    assert rep is not plan and rep._fb_t is not plan._fb_t
    assert _shard.replica(plan, torch.device("cpu")) is rep
    assert torch.equal(rep.spectrogram(batch), plan.spectrogram(batch))


# --- sharded mel ------------------------------------------------------------

def test_sharded_mel_vs_jax_and_unsharded(mesh, jmesh, batch):
    jp, tp = _plans()
    spec, cc = sharded_spectrogram_fn(tp, mesh, with_xxcc=13)(batch)
    xs = jax.device_put(batch, NamedSharding(jmesh, P("data", "time")))
    jspec, jcc = j_sharded.sharded_spectrogram_fn(jp, jmesh,
                                                  with_xxcc=13)(xs)
    assert tuple(spec.shape) == jspec.shape == (4, 128, 61)
    assert _rel(spec, jspec) <= 1e-4 and _rel(cc, jcc) <= 1e-4
    ref = tp.spectrogram(batch)
    assert _rel(spec, ref) <= 1e-6
    assert _rel(cc, tp.xxcc(ref, 13)) <= 1e-6


def test_sharded_fused_mel_vs_jax(mesh, jmesh):
    jp, tp = _plans()
    x = (np.random.default_rng(0).standard_normal((4, 4 * 512 * 16)) * 0.2
         ).astype(np.float32)
    mel, cc = sharded_spectrogram_fn(tp, mesh, with_xxcc=13, fused=True,
                                     fused_tile=8, fused_interpret=True)(x)
    jmel, jcc = j_sharded.sharded_spectrogram_fn(
        jp, jmesh, with_xxcc=13, fused=True, fused_tile=8,
        fused_interpret=True)(x)
    assert tuple(mel.shape) == jmel.shape == (4, 128, 61)
    assert _rel(mel, jmel) <= 1e-4 and _rel(cc, jcc) <= 1e-4
    umel, ucc = tp.spectrogram_mfcc_fused(x, cc_num=13)
    assert _rel(mel, umel[..., :61]) <= 1e-6
    assert _rel(cc, ucc[..., :61]) <= 1e-6


@pytest.mark.parametrize("data,time", [(1, 1), (1, 2), (2, 2), (4, 2),
                                       (2, 4), (1, 8)])
@pytest.mark.parametrize("tail", [0, 3 * SLIDE])
def test_device_count_sweep(data, time, tail):
    """The sharded mel on every grid, with frames that spill unevenly
    across shards, against the port's unsharded call."""
    plan = aft.MelSpectrogram(num=64, samplate=SR, radix2_exp=11,
                              slide_length=SLIDE, device="cpu")
    m = make_mesh(data=data, time=time, devices=CPU8)
    n = 8 * time * SLIDE + tail
    n -= n % (time * SLIDE)
    x = (np.random.default_rng(data * 16 + time + tail).standard_normal(
        (2 * data, n)) * 0.2).astype(np.float32)
    spec, cc = sharded_spectrogram_fn(plan, m, with_xxcc=13)(x)
    want = plan.spectrogram(x)
    assert spec.shape == want.shape
    assert _rel(spec, want) <= 2e-6
    assert _rel(cc, plan.xxcc(want, 13)) <= 2e-6


def test_sharded_mel_errors(mesh):
    _, plan = _plans()
    fn = sharded_spectrogram_fn(plan, mesh)
    x = np.zeros((4, 4 * SLIDE * 4 + 2), np.float32)
    with pytest.raises(ValueError, match="divide the time"):
        fn(x)                                   # n not a multiple of 4
    with pytest.raises(ValueError, match="multiple of slide_length"):
        fn(np.zeros((4, 4 * (SLIDE + 4)), np.float32))
    with pytest.raises(ValueError, match="shorter than the halo"):
        fn(np.zeros((4, 4 * SLIDE), np.float32))   # block < fft - slide
    with pytest.raises(ValueError, match="batch 3"):
        fn(np.zeros((3, 4 * 4 * SLIDE), np.float32))
    with pytest.raises(ValueError, match="fused sharded path"):
        sharded_spectrogram_fn(plan, mesh, fused=True)
    mag = aft.MelSpectrogram(num=128, radix2_exp=11, slide_length=SLIDE,
                             data_type=aft.SpectralDataType.MAG, device="cpu")
    with pytest.raises(ValueError, match="fused sharded path"):
        sharded_spectrogram_fn(mag, mesh, with_xxcc=13, fused=True)


@pytest.mark.parametrize("n,fft,slide", [(32768, 2048, 512), (8192, 2048, 512),
                                         (4096, 256, 64), (2048, 2048, 512),
                                         (10000, 1024, 300)])
def test_valid_frames(n, fft, slide):
    assert valid_frames(n, fft, slide) == j_sharded.valid_frames(n, fft, slide)
    assert valid_frames(n, fft, slide) == (n - fft) // slide + 1


# --- sharded STFT / ISTFT ---------------------------------------------------

@pytest.fixture(scope="module")
def stft_pair():
    return (j_window(af.WindowType.HANN, FFT),
            aft.STFT(11, WindowType.HANN, SLIDE, device="cpu"))


def test_sharded_stft_frames(mesh, jmesh, batch, stft_pair):
    win, st = stft_pair
    D = sharded_stft_fn(mesh, FFT, SLIDE, win)(batch)
    assert D.shape[1] == valid_frames(batch.shape[-1], FFT, SLIDE)
    assert torch.equal(D.transpose(-1, -2), st.stft(batch))
    xs = jax.device_put(batch, NamedSharding(jmesh, P("data", "time")))
    Dj = j_sharded.sharded_stft_fn(jmesh, FFT, SLIDE, win)(xs)
    assert _rel(D, Dj) <= 1e-4


def test_sharded_istft_vs_unsharded_and_jax(mesh, jmesh, batch, stft_pair):
    win, st = stft_pair
    D = sharded_stft_fn(mesh, FFT, SLIDE, win)(batch)
    y = sharded_istft_fn(mesh, FFT, SLIDE, win)(D)
    assert y.shape == batch.shape
    assert _rel(y, st.istft(D.transpose(-1, -2))) <= 1e-5
    n = batch.shape[-1]
    err = np.abs(_np(y)[:, FFT:n - FFT] - batch[:, FFT:n - FFT]).max()
    assert err < 1e-3
    yj = j_sharded.sharded_istft_fn(jmesh, FFT, SLIDE, win)(_np(D))
    assert _rel(y, yj) <= 1e-4


@pytest.mark.parametrize("t", [7, 13, 61])
@pytest.mark.parametrize("method_type", [0, 1])
def test_sharded_istft_any_frame_count(mesh, stft_pair, t, method_type):
    """Any T: the padding rule t_pad = ceil((t + ceil(halo/slide)) / 4) * 4
    and the masks leave the unsharded inverse's values."""
    win, st = stft_pair
    rng = np.random.default_rng(t)
    D = (rng.standard_normal((2, t, FFT // 2 + 1))
         + 1j * rng.standard_normal((2, t, FFT // 2 + 1))).astype(np.complex64)
    y = sharded_istft_fn(mesh, FFT, SLIDE, win, method_type=method_type)(D)
    ref = st.istft(torch.from_numpy(D).transpose(-1, -2),
                   method_type=method_type)
    assert y.shape == ref.shape == (2, (t - 1) * SLIDE + FFT)
    assert _rel(y, ref) <= 1e-5


def test_sharded_istft_frames_too_few(mesh, stft_pair):
    """One frame over four shards leaves each shard's overlap-add shorter
    than the halo it hands on: refused, not wrapped."""
    win, _ = stft_pair
    D = np.zeros((2, 1, FFT // 2 + 1), np.complex64)
    with pytest.raises(ValueError, match="do not cover"):
        sharded_istft_fn(mesh, FFT, SLIDE, win)(D)


def test_sharded_spectral_stats_vs_jax(mesh, jmesh):
    S = np.random.default_rng(0).random((4, 16, 64)).astype(np.float32)
    out = sharded_spectral_stats_fn(mesh)(S)
    jout = j_stats(jmesh)(jax.device_put(
        S, NamedSharding(jmesh, P("data", None, "time"))))
    for k in ("sum", "mean", "max", "var"):
        assert tuple(out[k].shape) == (4, 16)
        np.testing.assert_allclose(_np(out[k]), np.asarray(jout[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(_np(out["mean"]), S.mean(-1), rtol=1e-5)
    np.testing.assert_allclose(_np(out["max"]), S.max(-1), rtol=1e-6)
    np.testing.assert_allclose(_np(out["var"]), S.var(-1), rtol=1e-3,
                               atol=1e-5)
    with pytest.raises(ValueError, match="spectral stats"):
        sharded_spectral_stats_fn(mesh)(S[..., :63])
