"""The rest of the port's surface on the CPU: WAV I/O (``io.wave`` and the
native loader), ``observe``, ``utils`` (every function against the JAX
package's on the same seeded inputs), ``fftlib``, ``display`` (skipped
without matplotlib), an import walk that finds no JAX in the port, and
name parity with the JAX package.

The name-parity test replaces, for the port, the reference sweep of
tests/test_surface_sweep.py: every public name of the JAX modules listed
in ``PARITY`` has a counterpart of the same name in the port, whose
signature accepts every JAX parameter name."""

import ast
import glob
import importlib
import inspect
import os
import types
import wave as std_wave

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.utils import convert as j_convert
from audioflux_torch.io import native
from audioflux_torch.utils import convert as t_convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- io ---------------------------------------------------------------------

@pytest.mark.parametrize("subtype,tol", [("PCM_32", 1e-9), ("PCM_16", 1e-4)])
@pytest.mark.parametrize("channels", [1, 2])
def test_wave_round_trip_and_jax_read(tmp_path, subtype, tol, channels):
    rng = np.random.default_rng(channels)
    x = (rng.uniform(-0.9, 0.9, (channels, 3000)).astype(np.float32)
         if channels > 1 else rng.uniform(-0.9, 0.9, 3000).astype(np.float32))
    p = str(tmp_path / "a.wav")
    aft.write(p, x, samplate=16000, subtype=subtype)
    y, sr = aft.read(p, is_mono=False)
    assert sr == 16000 and y.shape == (channels, 3000)
    np.testing.assert_allclose(y.reshape(x.shape), x, atol=tol)
    yj, srj = af.read(p, is_mono=False)
    assert srj == sr and np.array_equal(y, yj)
    ym, _ = aft.read(p)
    assert np.array_equal(ym, af.read(p)[0])
    assert np.array_equal(aft.convert_mono(y), af.convert_mono(y))


def test_wave_full_scale_32_bit(tmp_path):
    """A sample of exactly +-1.0 keeps its sign in 32-bit PCM: the port
    scales in float64 (float32 rounds 1.0 * (2**31 - 1) up to 2**31, which
    wraps to -2**31)."""
    x = np.array([1.0, -1.0, 0.5, 1.5, -2.0], np.float32)
    p = str(tmp_path / "full.wav")
    aft.write(p, x)
    with std_wave.open(p, "rb") as w:
        pcm = np.frombuffer(w.readframes(5), "<i4")
    assert pcm.tolist() == [2**31 - 1, -(2**31 - 1), 2**30 - 1, 2**31 - 1,
                            -(2**31 - 1)]
    y, _ = aft.read(p)
    np.testing.assert_allclose(y, np.clip(x, -1, 1), atol=1e-9)
    ws = str(tmp_path / "stream.wav")
    with aft.WaveWriter(ws, bit=32) as w:
        w.write(x)
    np.testing.assert_allclose(aft.read(ws)[0], np.clip(x, -1, 1), atol=1e-9)


def test_wave_read_list_dir_and_resample(tmp_path):
    for i in range(3):
        aft.write(str(tmp_path / f"f{i}.wav"),
                  np.full(4000, 0.1 * i, np.float32), samplate=32000)
    paths = sorted(str(p) for p in tmp_path.glob("*.wav"))
    y, _ = aft.read(paths)
    assert y.shape == (3, 4000) and np.array_equal(y, af.read(paths)[0])
    yd, _ = aft.read(dir=str(tmp_path))
    assert yd.shape == (3, 4000)
    yr, sr = aft.read(paths[1], samplate=16000)
    yrj, _ = af.read(paths[1], samplate=16000)
    assert sr == 16000 and yr.shape == np.asarray(yrj).shape
    np.testing.assert_allclose(yr, np.asarray(yrj), atol=1e-6)


def test_wave_streaming_and_chirp(tmp_path):
    p = str(tmp_path / "s.wav")
    x = aft.chirp(100, 4000, 0.25, samplate=16000)
    assert np.array_equal(x, af.chirp(100, 4000, 0.25, samplate=16000))
    x = x.astype(np.float32)
    with aft.WaveWriter(p, samplate=16000, bit=32) as w:
        w.write(x[:1000])
        w.write(x[1000:])
    with aft.WaveReader(p) as r:
        assert r.get_infor() == {"samplate": 16000, "bit": 32,
                                 "channel_num": 1}
        a, b = r.read(1500), r.read(10 ** 6)
    np.testing.assert_allclose(np.concatenate([a, b]), np.clip(x, -1, 1),
                               atol=1e-7)
    with pytest.raises(ValueError):
        aft.WaveWriter(str(tmp_path / "bad.wav"), bit=8)


def test_native_builds_into_the_port_build_dir():
    assert native.available()
    path = native.library_path()
    assert path.parent == (
        __import__("pathlib").Path(REPO) / "audioflux_torch" / "_build")
    assert path.exists() and path.name.startswith("libafio-")


def test_native_load_batch_vs_wave(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate([5000, 8000, 3000]):
        p = str(tmp_path / f"n{i}.wav")
        aft.write(p, rng.uniform(-0.5, 0.5, n).astype(np.float32),
                  samplate=32000)
        paths.append(p)
    batch, good = native.load_batch(paths + [str(tmp_path / "nope.wav")],
                                    6000, num_threads=2)
    assert good == 3 and batch.shape == (4, 6000)
    for i, p in enumerate(paths):
        y, _ = aft.read(p)
        m = min(len(y), 6000)
        np.testing.assert_allclose(batch[i, :m], y[:m], atol=1e-7)
        assert not batch[i, m:].any()
    assert not batch[3].any()
    assert native.wav_info(paths[1]) == (8000, 32000, 1)
    y, sr = native.wav_read(paths[1])
    np.testing.assert_allclose(y, aft.read(paths[1])[0], atol=1e-7)
    q = str(tmp_path / "w.wav")
    native.wav_write(q, y, samplate=sr)                   # 16-bit PCM
    np.testing.assert_allclose(aft.read(q)[0], y, atol=2 / 32767)
    with native.PrefetchLoader(paths * 3, batch_size=4, length=6000,
                               num_threads=2) as it:
        seen = [(b.shape, g) for b, g in it]
    assert seen == [((4, 6000), 4), ((4, 6000), 4), ((1, 6000), 1)]


def test_native_build_failure_raises_with_gpp_message(tmp_path, monkeypatch):
    from audioflux_torch.ops import _build
    bad = tmp_path / "wavio.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setitem(_build.HOST, "libafio",
                        (bad, _build.HOST["libafio"][1]))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    native._load.cache_clear()
    with pytest.raises(OSError, match="g\\+\\+ failed"):
        native.load_batch([], 10)
    assert not native.available()


# --- observe ----------------------------------------------------------------

def test_trace_finds_a_named_scope(tmp_path):
    from audioflux_torch import observe
    plan = aft.MelSpectrogram(num=32, radix2_exp=10, slide_length=256,
                              device="cpu")
    x = np.random.default_rng(0).standard_normal(8192).astype(np.float32)
    with observe.trace(str(tmp_path)):
        with observe.scope("af.mel_stage"):
            plan.spectrogram(x)
        with observe.scope("af.host_note"):
            pass
    assert glob.glob(str(tmp_path / "plugins/profile/*/*.trace.json.gz"))
    rows = observe.summarize_trace(str(tmp_path), top=500)
    names = {n: (us, c) for n, us, c in rows}
    assert "af.mel_stage" in names and names["af.mel_stage"][1] == 1
    assert "af.host_note" in names
    # the port's own span of the entry call, nested in the caller's
    assert names["af.MelSpectrogram.spectrogram"][1] == 1
    assert all(us >= 0 for _, us, _ in rows)
    with pytest.raises(FileNotFoundError):
        observe.summarize_trace(str(tmp_path / "empty"))


def test_metrics_registry():
    from audioflux_torch.observe import Metrics
    m = Metrics()
    m.count("clips", 3)
    m.count("clips")
    with m.timer("stage"):
        pass
    with m.timer("stage"):
        pass
    rep = m.report()
    assert rep["clips"] == 4 and rep["stage.calls"] == 2
    assert rep["stage.seconds"] >= 0
    m.reset()
    assert m.report() == {}


# --- utils ------------------------------------------------------------------

def _pos(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) + 1e-3).astype(
        np.float32)


@pytest.mark.parametrize("name,args,kw", [
    ("power_to_db", (), {}),
    ("power_to_db", (), {"min_db": -30.0}),
    ("power_to_abs_db", (), {"fft_length": 64}),
    ("power_to_abs_db", (), {"fft_length": 8, "is_norm": True}),
    ("mag_to_abs_db", (), {"fft_length": 16}),
    ("mag_to_abs_db", (), {"fft_length": 4, "is_norm": True,
                           "min_db": -20.0}),
    ("log_compress", (), {"gamma": 3.0}),
    ("log10_compress", (), {}),
    ("delta", (), {}),
    ("delta", (), {"order": 3}),
])
def test_convert_array_functions_vs_jax(name, args, kw):
    X = _pos((3, 40, 17), seed=len(name))
    got = getattr(aft.utils, name)(X, *args, **kw)
    want = np.asarray(getattr(af.utils, name)(X, *args, **kw))
    assert isinstance(got, torch.Tensor) and got.shape == want.shape
    np.testing.assert_allclose(_np(got), want, rtol=2e-6, atol=2e-5)


def test_convert_tensor_input_and_phase():
    rng = np.random.default_rng(3)
    D = (rng.standard_normal((5, 9)) + 1j * rng.standard_normal((5, 9))
         ).astype(np.complex64)
    D[0, 0] = 1e-20 + 1j
    got = aft.utils.get_phase(torch.from_numpy(D))
    np.testing.assert_allclose(_np(got), np.asarray(af.utils.get_phase(D)),
                               atol=1e-6)
    X = torch.from_numpy(_pos((4, 6)))
    assert aft.utils.power_to_db(X).device == X.device
    with pytest.raises(ValueError):
        aft.utils.delta(np.ones(4, np.float32))
    with pytest.raises(ValueError):
        aft.utils.delta(np.ones((4, 4), np.float32), order=4)


@pytest.mark.parametrize("midi", [0, 21, 60.4, 69, 127])
def test_note_functions_vs_jax(midi):
    assert aft.utils.midi_to_note(midi) == af.utils.midi_to_note(midi)
    assert aft.utils.midi_to_note(midi, is_octave=False) == \
        af.utils.midi_to_note(midi, is_octave=False)
    hz = float(af.utils.midi_to_hz(midi))
    assert aft.utils.hz_to_note(hz) == af.utils.hz_to_note(hz)
    note = af.utils.midi_to_note(midi)
    assert aft.utils.note_to_hz(note) == af.utils.note_to_hz(note)
    assert aft.utils.note_to_midi(note) == af.utils.note_to_midi(note)


def test_temproal_db_vs_jax():
    x = np.random.default_rng(5).uniform(-1, 1, 2000).astype(np.float32)
    x[:100] = 0
    assert aft.utils.temproal_db(x) == af.utils.temproal_db(x)
    assert aft.utils.temproal_db(x, base=6.0) == \
        af.utils.temproal_db(x, base=6.0)
    assert aft.utils.temproal_db(np.zeros(0, np.float32)) == (0.0, 0.0, 0.0)


@pytest.mark.parametrize("name", ["220", "880", "voice"])
def test_sample_path_in_the_port_tree(name):
    """The samples are written under the port's own directory; the
    noise-free ones equal the JAX package's synthesis."""
    p = aft.utils.sample_path(name)
    assert os.path.dirname(p) == os.path.join(REPO, "audioflux_torch",
                                              "utils", "sample_data")
    y, sr = aft.read(p)
    want = j_convert._synth_sample(name, 32000)
    assert sr == 32000 and y.shape == want.shape
    np.testing.assert_allclose(y, want, atol=2 / 32767)   # 16-bit PCM


def test_sample_synthesis_is_the_same_in_every_process():
    a = t_convert._synth_sample("guitar_chord1")
    b = t_convert._synth_sample("guitar_chord1")
    assert np.array_equal(a, b) and np.abs(a).max() <= 1.0


@pytest.mark.parametrize("rows", [1, 2, 5, 8, 9])
@pytest.mark.parametrize("name", ["min_max_scale", "standard_scale",
                                  "max_abs_scale", "robust_scale",
                                  "center_scale", "mean_scale",
                                  "arctan_scale"])
def test_scale_vs_jax(name, rows):
    X = np.random.default_rng(rows).standard_normal((rows, 6)).astype(
        np.float32)
    X[:, 2] = 1.5                               # a constant column
    got = getattr(aft.utils, name)(X)
    want = np.asarray(getattr(af.utils, name)(X))
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6,
                               equal_nan=True)


def test_standard_scale_sample_variance_vs_jax():
    X = np.random.default_rng(0).standard_normal((7, 4)).astype(np.float32)
    np.testing.assert_allclose(_np(aft.utils.standard_scale(X, tp=0)),
                               np.asarray(af.utils.standard_scale(X, tp=0)),
                               rtol=1e-5, atol=1e-6)
    assert aft.utils.stand_scale is aft.utils.standard_scale


def test_weight_and_util_vs_jax():
    fre = np.linspace(10, 16000, 50).astype(np.float32)
    for k in "abcd":
        np.testing.assert_array_equal(getattr(aft.utils, f"weight_{k}")(fre),
                                      getattr(af.utils, f"weight_{k}")(fre))
        assert getattr(aft.utils, f"auditory_weight_{k}") is \
            getattr(aft.utils, f"weight_{k}")
    x = np.random.default_rng(1).standard_normal((2, 3, 100)).astype(
        np.float32)
    for r2e in (6, 7):                  # truncate, then zero-pad
        with pytest.warns(UserWarning):
            got = aft.utils.check_audio_length(x, r2e)
        with pytest.warns(UserWarning):
            want = af.utils.check_audio_length(x, r2e)
        assert got.shape[-1] == 1 << r2e and np.array_equal(got, want)
    assert aft.utils.check_audio(x[0, 0])
    with pytest.raises(ValueError):
        aft.utils.check_audio(x)
    X2, lead = aft.utils.format_channel(x, 1)
    assert X2.shape == (6, 100) and lead == (2, 3)
    assert np.array_equal(aft.utils.revoke_channel(X2, lead, 1), x)
    np.testing.assert_array_equal(
        aft.utils.synth_f0([0, 0.5, 1.0], [220, 440, 330], 8000,
                           amplitudes=[1, 0.5, 1]),
        af.utils.synth_f0([0, 0.5, 1.0], [220, 440, 330], 8000,
                          amplitudes=[1, 0.5, 1]))
    assert aft.utils.ascontiguous_T(x[0]).flags.c_contiguous
    assert aft.utils.ascontiguous_swapaxex(x, 0, 2).shape == (100, 3, 2)


# --- fftlib -----------------------------------------------------------------

def test_fftlib():
    from audioflux_torch import fftlib
    name = fftlib.get_fft_lib_name()
    assert name == ("cuda" if torch.cuda.is_available() else "cpu")
    assert fftlib.get_fft_lib() is torch.fft
    assert fftlib.get_fft_lib_fp() == torch.__file__
    md5 = fftlib.get_lib_md5()
    assert len(md5) == 32 and md5 == fftlib.get_lib_md5()
    assert fftlib.set_fft_lib("linux", lib_ext=".so", path="x") is None


# --- imports ----------------------------------------------------------------

def _port_files():
    files = glob.glob(os.path.join(REPO, "audioflux_torch", "**", "*.py"),
                      recursive=True)
    return files + [os.path.join(REPO, "chip_smoke.py")]


def test_port_imports_no_jax():
    """No ``import`` or ``from ... import`` of jax or audioflux_tpu in the
    port or in chip_smoke.py (docstrings may cite the JAX modules)."""
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                if m.split(".")[0] in ("jax", "jaxlib", "audioflux_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} "
                               f"{m}")
    assert len(_port_files()) > 50
    assert not bad, bad


# --- display ----------------------------------------------------------------

def test_display_takes_tensors(tmp_path):
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt
    from audioflux_torch.display import Plot, fill_plot, fill_spec, fill_wave
    spec = torch.rand((24, 40), generator=torch.Generator().manual_seed(0))
    fig, ax = plt.subplots()
    x = np.linspace(0.0, 2.0, 41)
    y = np.linspace(0.0, 16000.0, 25)
    img = fill_spec(spec, axes=ax, x_coords=x, y_coords=y, x_axis="time",
                    y_axis="log", title="t")
    assert img.get_array().size == spec.numel()
    assert ax.get_yscale() == "symlog" and ax.get_title() == "t"
    with pytest.warns(UserWarning, match="abs"):
        fill_spec(torch.complex(spec, spec), axes=ax)
    fill_plot(torch.arange(10.0), torch.rand(10), axes=ax, label="l")
    fill_wave(torch.sin(torch.arange(3200.0) / 50), samplate=3200, axes=ax)
    assert ax.get_xlim()[1] == pytest.approx(3199 / 3200)
    plt.close(fig)
    p = Plot(2, 1)
    p.add_spec_data(spec, row_idx=0)
    p.add_plot_data(torch.rand(20), title="x")
    p.save(str(tmp_path / "p.png"))
    p.close()
    assert (tmp_path / "p.png").stat().st_size > 0
    from audioflux_torch.display import ChromaFormatter, TimeFormatter
    assert ChromaFormatter(1)(0) == "C" and TimeFormatter is not None


# --- name parity ------------------------------------------------------------

PARITY = ["", ".utils", ".display", ".fftlib", ".observe", ".parallel",
          ".parallel.mesh", ".parallel.sharded", ".parallel.sharded_full",
          ".parallel.features", ".parallel.pipeline", ".parallel.runner",
          ".parallel.distributed", ".io", ".io.wave", ".io.native",
          ".types", ".spectrogram", ".ops.backend"]

# TPU-only names with no counterpart, by design: the JAX backend probe and
# the GSPMD pin of the native XLA FFT (an explicit shard runs its own
# kernels, so there is nothing to pin), and observe's ``annotate``, which
# ``scope`` covers (the port has one way to open a span)
TPU_ONLY = {".ops.backend": {"effective_backend", "on_tpu",
                             "native_fft_scope", "native_fft_pinned"},
            ".observe": {"annotate"}}


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n)
        home = (obj.__name__ if isinstance(obj, types.ModuleType)
                else getattr(obj, "__module__", None))
        if home and not home.startswith("audioflux_tpu"):
            continue            # numpy, jax and the like, imported
        out.append(n)
    return out


@pytest.mark.parametrize("suffix", PARITY)
def test_name_parity(suffix):
    j = importlib.import_module("audioflux_tpu" + suffix)
    t = importlib.import_module("audioflux_torch" + suffix)
    allowed = TPU_ONLY.get(suffix, set())
    names = _public(j)
    assert names
    missing = [n for n in names if not hasattr(t, n) and n not in allowed]
    assert not missing, missing
    assert not [n for n in allowed if hasattr(t, n) or n not in names]
    for n in names:
        if n in allowed:
            continue
        jo, to = getattr(j, n), getattr(t, n)
        if isinstance(jo, types.ModuleType) or not callable(jo):
            continue
        try:
            js, ts = inspect.signature(jo), inspect.signature(to)
        except (TypeError, ValueError):
            continue
        if any(p.kind == p.VAR_KEYWORD for p in ts.parameters.values()):
            continue
        lack = [p for p, v in js.parameters.items()
                if p not in ts.parameters
                and v.kind not in (v.VAR_POSITIONAL, v.VAR_KEYWORD)]
        assert not lack, f"{suffix or 'top'}.{n} lacks {lack}"
