"""The port's STFT/ISTFT on the CPU (``device="cpu"``) against the JAX
package on the CPU, its inverse Pallas kernel in interpret mode, and the
reference C goldens (the tolerances of tests/test_stft.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.ops.pad import pad_signal as jpad
from audioflux_tpu.ops.window import get_fft_window
from audioflux_tpu.transforms import stft as jstft
from audioflux_tpu.types import (PaddingModeType, PaddingPositionType,
                                 WindowType)
from audioflux_torch.ops.pad import pad_signal as tpad
from audioflux_torch.transforms import stft as tstft
from tests.conftest import assert_close_to_golden

CPU = {"device": "cpu"}
N = 2048


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30)


def _pair(pad=None, window=WindowType.HANN, slide=512, **kw):
    j = af.STFT(radix2_exp=11, window_type=window, slide_length=slide, **kw)
    t = aft.STFT(radix2_exp=11, window_type=window, slide_length=slide,
                 **kw, **CPU)
    for st in (j, t):
        if pad is not None:
            st.enable_padding(True)
            st.set_padding(*pad)
    return j, t


@pytest.mark.parametrize("position", list(PaddingPositionType))
@pytest.mark.parametrize("mode", list(PaddingModeType))
def test_pad_signal_equals_jax(position, mode):
    """Every position x mode, 1-D and batched, with a fractional value1:
    LEFT/RIGHT constant padding truncates it toward zero, CENTER keeps it."""
    rng = np.random.default_rng(int(position) * 3 + int(mode))
    for shape in ((1000,), (2, 3, 777)):
        x = rng.standard_normal(shape).astype(np.float32)
        for v1, v2 in ((0.0, 0.0), (2.7, -1.3), (-2.7, 0.5)):
            ref = np.asarray(jpad(jnp.asarray(x), 256, 100, position, mode,
                                  v1, v2))
            got = tpad(torch.from_numpy(x), 256, 100, position, mode, v1, v2)
            assert np.array_equal(got.numpy(), ref), (shape, v1)
    if mode == PaddingModeType.CONSTANT:
        edge = got.numpy()[..., 0 if position != PaddingPositionType.RIGHT
                           else -1]
        want = {PaddingPositionType.CENTER: -2.7,
                PaddingPositionType.LEFT: -2.0,
                PaddingPositionType.RIGHT: -2.0}[position]
        if position == PaddingPositionType.CENTER:
            assert np.all(edge == np.float32(want))
        else:
            assert np.all(edge == want)


def test_stft_matches_jax_and_golden(goldens, signals):
    g = goldens("stft")
    j, t = _pair()
    D = t.stft(signals["sine"])
    assert D.dtype == torch.complex64 and D.shape[-2] == N // 2 + 1
    assert _rel(D, j.stft(signals["sine"])) <= 1e-5
    assert_close_to_golden(_np(D).real, g["stft_re"], 5e-5, "stft real")
    assert_close_to_golden(_np(D).imag, g["stft_im"], 5e-5, "stft imag")
    assert np.array_equal(t.y_coords(), j.y_coords())
    assert np.array_equal(t.x_coords(32000), j.x_coords(32000))
    assert t.cal_data_length(59) == j.cal_data_length(59)


@pytest.mark.parametrize("tag,pos,mode", [
    ("center_const", PaddingPositionType.CENTER, PaddingModeType.CONSTANT),
    ("center_reflect", PaddingPositionType.CENTER, PaddingModeType.REFLECT),
    ("center_wrap", PaddingPositionType.CENTER, PaddingModeType.WRAP),
    ("right_reflect", PaddingPositionType.RIGHT, PaddingModeType.REFLECT),
    ("left_reflect", PaddingPositionType.LEFT, PaddingModeType.REFLECT),
])
def test_stft_padded_matches_jax_and_golden(goldens, signals, tag, pos, mode):
    g = goldens("stft")
    j, t = _pair(pad=(pos, mode, 0.0, 0.0))
    x = signals["sine"]
    assert t.cal_time_length(len(x)) == j.cal_time_length(len(x))
    D = t.stft(x)
    assert D.shape[-1] == t.cal_time_length(len(x))
    assert _rel(D, j.stft(x)) <= 1e-5
    assert_close_to_golden(_np(D).real, g[f"stft_{tag}_re"], 5e-5, tag)
    assert_close_to_golden(_np(D).imag, g[f"stft_{tag}_im"], 5e-5, tag)


def test_set_padding_needs_enable_and_keeps_values():
    j, t = _pair()
    for st in (j, t):
        st.set_padding(PaddingPositionType.LEFT, PaddingModeType.WRAP, 1.5)
    assert t.position == j.position == PaddingPositionType.CENTER
    j, t = _pair(pad=(PaddingPositionType.LEFT, PaddingModeType.CONSTANT,
                      2.7, 0.0))
    x = np.random.default_rng(2).standard_normal(5000).astype(np.float32)
    assert (t.position, t.mode, t.value1) == (j.position, j.mode, j.value1)
    assert _rel(t.stft(x), j.stft(x)) <= 1e-5


@pytest.mark.parametrize("slide", [512, 600])
@pytest.mark.parametrize("method_type", [0, 1])
def test_istft_matches_jax(signals, slide, method_type):
    """fft % slide == 0 and not, both normalisations; the first and last
    fft_length samples are the documented edge class (window sums near the
    1e-6 clamp amplify FFT rounding), so the interior is held tightly."""
    j, t = _pair(slide=slide)
    x = np.stack([signals["sine"][:20000], signals["chirp"][:20000]])
    D = np.asarray(j.stft(x))
    ref = np.asarray(j.istft(D, method_type=method_type))
    got = _np(t.istft(D, method_type=method_type))
    assert got.shape == ref.shape
    sc = np.max(np.abs(ref[..., N:-N]))
    assert np.max(np.abs(got - ref)[..., N:-N]) / sc <= 1e-4
    if method_type == 0:        # the weighted form's edges: ~1e3 x rounding
        assert _rel(got, ref) <= 1e-3
    # functional form, same numbers
    fn = aft.istft(D, N, slide, WindowType.HANN, method_type, **CPU)
    assert np.array_equal(_np(fn), got)


def test_istft_golden_and_round_trip(goldens, signals):
    g = goldens("stft")
    _, t = _pair()
    x = signals["sine"]
    D = t.stft(x)
    y_w, y_o = _np(t.istft(D, 0)), _np(t.istft(D, 1))
    # the last samples divide by window-energy sums just above the 1e-6
    # clamp, so FFT rounding is amplified there by up to ~1e3 (the JAX
    # package itself sits at 9.3e-5 of the peak, at the same sample): the
    # interior is held at 1e-4, the edges at 1e-3
    assert_close_to_golden(y_w[N:-N], g["istft_w"][N:-N], 1e-4,
                           "istft weighted interior")
    assert_close_to_golden(y_w, g["istft_w"], 1e-3, "istft weighted edges")
    assert_close_to_golden(y_o[N:-N], g["istft_ola"][N:-N], 1e-4,
                           "istft ola interior")
    assert_close_to_golden(y_o, g["istft_ola"], 5e-2, "istft ola edges")
    n = min(len(y_w), len(x))
    assert np.abs(y_w[N:n - N] - x[N:n - N]).max() < 1e-3


def test_istft_tm_matches_pallas_interpret():
    """_istft_tm / _istft_tm_pair against the JAX functions with the
    inverse Pallas kernel in interpret mode and with jnp.fft, also on a
    hermitian-inconsistent pair."""
    rng = np.random.default_rng(50)
    x = rng.standard_normal((2, 6 * N)).astype(np.float32)
    w = get_fft_window(WindowType.HANN, N)
    D = jstft._stft_impl(jnp.asarray(x), jnp.asarray(w), fft_length=N,
                         slide_length=512, is_pad=False, position=0, mode=0)
    spec = np.asarray(jnp.swapaxes(D, -1, -2))
    noise = (rng.standard_normal(spec.shape)
             + 1j * rng.standard_normal(spec.shape)).astype(np.complex64)
    kw = dict(fft_length=N, slide_length=512)
    tw, tspec = torch.from_numpy(w.copy()), torch.from_numpy(spec.copy())
    for mt in (0, 1):
        got = _np(tstft._istft_tm(tspec, tw, method_type=mt, **kw))
        for use_kernel in (True, False):
            ref = np.asarray(jstft._istft_tm(
                jnp.asarray(spec), jnp.asarray(w), method_type=mt,
                use_kernel=use_kernel, interpret=use_kernel, **kw))
            sc = np.max(np.abs(ref[..., N:-N]))
            assert np.max(np.abs(got - ref)[..., N:-N]) / sc <= 1e-4
    for a, b in ((spec, 0.5 * spec), (spec + noise, noise)):
        ga, gb = tstft._istft_tm_pair(torch.from_numpy(a.copy()),
                                      torch.from_numpy(b.copy()), tw,
                                      method_type=0, **kw)
        for use_kernel in (True, False):
            ra, rb = jstft._istft_tm_pair(
                jnp.asarray(a), jnp.asarray(b), jnp.asarray(w),
                method_type=0, use_kernel=use_kernel, interpret=use_kernel,
                **kw)
            sc = np.max(np.abs(np.asarray(ra)))
            for got, ref in ((ga, ra), (gb, rb)):
                err = np.abs(_np(got) - np.asarray(ref))
                assert np.max(err[..., N:-N]) / sc <= 1e-4
                assert np.max(err) / sc <= 5e-3     # the edge class
        # the pair equals two single ISTFTs (the DC/Nyquist imaginary
        # parts are forced to zero in both forms)
        sa = _np(tstft._istft_tm(torch.from_numpy(a.copy()), tw, method_type=0,
                                 **kw))
        err = np.abs(_np(ga) - sa) / np.max(np.abs(sa))
        assert np.max(err[..., N:-N]) <= 1e-5 and np.max(err) <= 5e-3


def test_streaming_stft_three_chunks(signals):
    x = signals["sine"]
    j = jstft.StreamingSTFT(11, WindowType.HANN, 512)
    t = aft.StreamingSTFT(11, WindowType.HANN, 512, **CPU)
    cols = []
    for chunk in (x[:1000], x[1000:9000], x[9000:20000]):
        ref = j.process(chunk)
        got = t.process(chunk)
        assert got.shape == ref.shape
        if ref.shape[-1]:
            assert _rel(got, ref) <= 1e-5
        cols.append(_np(got))
        assert t._carry.tail_len == j._carry.tail_len
        assert np.array_equal(_np(t._tail), j._tail)
    whole = aft.STFT(11, WindowType.HANN, 512, **CPU).stft(x[:20000])
    assert _rel(np.concatenate(cols, axis=-1), whole) <= 1e-6
    t.reset()
    assert t._carry.tail_len == 0 and t._tail is None


def test_is_continue_and_state_copy(signals):
    """is_continue carries the tail like the JAX plan; a port plan given
    the JAX plan's mid-stream state continues with the same frames."""
    x = signals["sine"]
    j, t = _pair(is_continue=True)
    for chunk in (x[:1000], x[1000:9000]):
        assert t.cal_time_length(len(chunk)) == j.cal_time_length(len(chunk))
        ref, got = j.stft(chunk), t.stft(chunk)
        assert got.shape == ref.shape
        if ref.shape[-1]:
            assert _rel(got, ref) <= 1e-5
    fresh = aft.STFT(11, WindowType.HANN, 512, is_continue=True, **CPU)
    aft.load_reference_constants(fresh, window=j.window,
                                 tail=j._carry.tail,
                                 tail_len=j._carry.tail_len)
    assert _rel(fresh.stft(x[9000:20000]), j.stft(x[9000:20000])) <= 1e-5
    with pytest.raises(ValueError):
        aft.load_reference_constants(aft.STFT(11, **CPU), window=j.window,
                                     tail=j._carry.tail, tail_len=5)
    # set_continue / set_slide_length reset the carry; slide > fft skips
    for st in (j, t):
        st.set_continue(True)
        st.set_slide_length(3000)
    for chunk in (x[:5000], x[5000:6000], x[6000:16000]):
        ref, got = j.stft(chunk), t.stft(chunk)
        assert got.shape == ref.shape
        if ref.shape[-1]:
            assert _rel(got, ref) <= 1e-5
    t.set_continue(False)
    assert t._carry is None and not t.is_continue


def test_use_window_data_arr_and_functional(signals):
    j, t = _pair(window=WindowType.RECT)
    w = np.hamming(N).astype(np.float32)
    for st in (j, t):
        st.use_window_data_arr(w)
    x = np.stack([signals["sine"][:9000], -signals["sine"][:9000]])
    D = t.stft(x)
    assert np.array_equal(t.get_window_data_arr(), w)
    assert _rel(D, j.stft(x)) <= 1e-5
    assert _rel(t.istft(D), j.istft(np.asarray(j.stft(x)))) <= 1e-4
    with pytest.raises(ValueError):
        t.use_window_data_arr(w[:-1])
    # functional forms: window_type and explicit window
    ref = jstft.stft(x, N, 512, WindowType.HAMM, is_pad=True,
                     mode=PaddingModeType.REFLECT)
    got = aft.stft(x, N, 512, WindowType.HAMM, is_pad=True,
                   mode=PaddingModeType.REFLECT, **CPU)
    assert _rel(got, ref) <= 1e-5
    got = aft.stft(torch.from_numpy(x), N, 512, window=w, **CPU)
    assert _rel(got, jstft.stft(x, N, 512, window=w)) <= 1e-5
    # load_reference_constants installs a JAX plan's window
    plain = aft.STFT(11, slide_length=512, **CPU)
    aft.load_reference_constants(plain, window=j.window)
    assert _rel(plain.stft(x), j.stft(x)) <= 1e-5
    with pytest.raises(ValueError):
        aft.load_reference_constants(plain, window=w[:-1])


def test_stft_device_policy(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros(4096, np.float32)
    for make in (lambda: aft.STFT(11), lambda: aft.StreamingSTFT(11),
                 lambda: aft.stft(x, N, 512),
                 lambda: aft.istft(np.zeros((1025, 3), np.complex64), N, 512)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    t = aft.STFT(11, **CPU)
    assert t.device == torch.device("cpu")
    with pytest.raises(ValueError):
        t.stft(torch.zeros(4096, device="meta"))
    with pytest.raises(ValueError):
        t.istft(torch.zeros((1025, 3), dtype=torch.complex64, device="meta"))
    with pytest.raises(ValueError):
        aft.STFT(0, **CPU)
