"""The port's classic family (NMF, Viterbi, HMM) and ``HPSSNMF`` on the
CPU (``device="cpu"``), against the JAX package on the same seeded inputs
and the reference C goldens (``classic``, the tolerances of
tests/test_classic.py)."""

import importlib

import numpy as np
import pytest
import torch

import audioflux_tpu as af
import audioflux_torch as aft
from audioflux_tpu.classic import nmf as j_nmf
from audioflux_tpu.classic import viterbi as j_viterbi
from tests.conftest import assert_close_to_golden

CPU = {"device": "cpu"}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------- NMF

def test_nmf_kl_matches_golden_and_jax(goldens):
    g = goldens("classic")
    kw = dict(w_arr=g["W0"], h_arr=g["H0"], max_iter=100, tp=0, thresh=1e-4,
              norm=0)
    W, H = (_np(a) for a in aft.nmf(g["V"], 4, **kw, **CPU))
    for Wr, Hr in ((g["W"], g["H"]),
                   tuple(np.asarray(a) for a in j_nmf(g["V"], 4, **kw))):
        np.testing.assert_allclose(W, Wr, atol=2e-2)
        np.testing.assert_allclose(H, Hr, atol=2e-1)
        rec_ours = np.abs(g["V"] - W @ H).mean()
        rec_ref = np.abs(g["V"] - Wr @ Hr).mean()
        assert rec_ours <= rec_ref * 1.05


@pytest.mark.parametrize("tp", [0, 1, 2], ids=["kl", "is", "euclidean"])
@pytest.mark.parametrize("norm", [0, 1, 2])
def test_nmf_types_match_jax(goldens, tp, norm):
    """KL, IS and Euclidean under each column norm, against JAX at
    tests/test_classic.py's tolerances, and the error falls."""
    g = goldens("classic")
    V = g["V"]
    kw = dict(w_arr=g["W0"], h_arr=g["H0"], max_iter=150, tp=tp,
              thresh=1e-5, norm=norm)
    W, H = (_np(a) for a in aft.nmf(V, 4, **kw, **CPU))
    Wj, Hj = (np.asarray(a) for a in j_nmf(V, 4, **kw))
    np.testing.assert_allclose(W, Wj, atol=2e-2)
    np.testing.assert_allclose(H, Hj, atol=2e-1)
    rec = np.abs(V - W @ H).mean()
    assert rec <= np.abs(V - Wj @ Hj).mean() * 1.05
    assert rec < np.abs(V - g["W0"] @ g["H0"]).mean()


def test_nmf_stop_rule(monkeypatch):
    """The loop stops after the first update where both ||dW|| and ||dH||
    fall below thresh (the first update always runs), and the seeded start
    is JAX's: the factors agree at tests/test_classic.py's tolerances."""
    # the package's ``nmf`` is the function; the module by its path
    tmod = importlib.import_module("audioflux_torch.classic.nmf")
    V = np.abs(np.random.default_rng(2).standard_normal((24, 30))).astype(
        np.float32)
    seen = []
    real = tmod._update

    def spy(V_, W, H, tp, norm):
        out = real(V_, W, H, tp, norm)
        seen.append((W, H) + out)
        return out
    monkeypatch.setattr(tmod, "_update", spy)
    thresh = 2e-2
    W, H = (_np(a) for a in aft.NMF(3, max_iter=400, thresh=thresh,
                                    **CPU).nmf(V, seed=5))
    deltas = [max(float(torch.linalg.norm(Wn - Wp)),
                  float(torch.linalg.norm(Hn - Hp)))
              for Wp, Hp, Wn, Hn in seen]
    assert 1 < len(seen) < 400
    assert deltas[-1] < thresh and min(deltas[:-1]) >= thresh
    np.testing.assert_array_equal(W, _np(seen[-1][2]))
    Wj, Hj = (np.asarray(a) for a in af.NMF(3, max_iter=400,
                                            thresh=thresh).nmf(V, seed=5))
    np.testing.assert_allclose(W, Wj, atol=2e-2)
    np.testing.assert_allclose(H, Hj, atol=2e-1)


# --------------------------------------------------------------- Viterbi

def test_viterbi_matches_golden_and_jax(goldens):
    g = goldens("classic")
    s, p, probs = aft.viterbi(g["pi"], g["A"], g["B"], g["o"], **CPU)
    np.testing.assert_array_equal(_np(s), g["vit_s"])
    np.testing.assert_allclose(float(p), g["vit_prob"], rtol=1e-5)
    np.testing.assert_allclose(_np(probs), g["vit_m"], rtol=1e-5)
    sj, pj, mj = j_viterbi(g["pi"], g["A"], g["B"], g["o"])
    np.testing.assert_array_equal(_np(s), np.asarray(sj))
    np.testing.assert_allclose(_np(probs), np.asarray(mj), rtol=1e-5)


@pytest.mark.parametrize("is_log", [False, True])
def test_viterbi_seeded_matches_jax(is_log):
    """A seeded 8-state, 12-symbol model over 200 steps (log domain) or 12
    (the probability domain: its products reach float32's subnormals near
    step 20, which JAX's CPU backend flushes to zero and PyTorch keeps):
    states equal, probabilities at 1e-5 relative; o=None takes
    arange(N)."""
    h = aft.HMM(8, 12, seed=4, **CPU)
    o, _ = h.generate(200 if is_log else 12, seed=6)
    s, p, m = aft.viterbi(h.pi, h.A, h.B, o, is_log=is_log, **CPU)
    sj, pj, mj = j_viterbi(h.pi, h.A, h.B, o, is_log=is_log)
    np.testing.assert_array_equal(_np(s), np.asarray(sj))
    np.testing.assert_allclose(_np(m), np.asarray(mj), rtol=1e-5)
    np.testing.assert_allclose(float(p), float(pj), rtol=1e-5)
    s0, _, _ = aft.viterbi(h.pi, h.A, h.B, is_log=is_log, **CPU)
    np.testing.assert_array_equal(
        _np(s0), np.asarray(j_viterbi(h.pi, h.A, h.B, is_log=is_log)[0]))


# ------------------------------------------------------------------- HMM

def _pair(g):
    t, j = aft.HMM(3, 3, seed=0, **CPU), af.HMM(3, 3, seed=0)
    for h in (t, j):
        h.init(g["hmm_pi0"], g["hmm_A0"], g["hmm_B0"])
    return t, j, np.asarray(g["hmm_o"], np.int64)


def test_hmm_predict_train_decode_match_golden_and_jax(goldens):
    """predict, ten single-step trains and the decode of the trained model
    against the C's trajectory (test_classic.py's bounds) and JAX's at
    1e-4."""
    g = goldens("classic")
    t, j, o = _pair(g)
    np.testing.assert_allclose(t.predict(o), g["hmm_p0"], rtol=1e-5)
    np.testing.assert_allclose(t.predict(o), j.predict(o), rtol=1e-4)
    for i in range(g["hmm_traj_A"].shape[0]):
        t.train(o, max_iter=1, error=0.0)
        j.train(o, max_iter=1, error=0.0)
        for got, ref, gold in ((t.pi, j.pi, g["hmm_traj_pi"][i]),
                               (t.A, j.A, g["hmm_traj_A"][i]),
                               (t.B, j.B, g["hmm_traj_B"][i])):
            np.testing.assert_allclose(got, gold, atol=5e-6)
            np.testing.assert_allclose(got, ref, atol=1e-4)
        np.testing.assert_allclose(t.predict(o), g["hmm_traj_p"][i],
                                   rtol=1e-4)
    s, prob = t.decode(o)
    np.testing.assert_array_equal(s, g["hmm_dec_s"])
    np.testing.assert_allclose(prob, g["hmm_dec_prob"], rtol=1e-4)
    sj, pj = j.decode(o)
    np.testing.assert_array_equal(s, sj)
    np.testing.assert_allclose(prob, pj, rtol=1e-4)


def test_hmm_seeded_train_generate_match_jax():
    """A seeded model: the same draws (generate), Baum-Welch to
    convergence with the same iteration count, parameters at 1e-4."""
    t, j = aft.HMM(4, 6, seed=3, **CPU), af.HMM(4, 6, seed=3)
    for a, b in ((t.pi, j.pi), (t.A, j.A), (t.B, j.B)):
        np.testing.assert_array_equal(a, b)
    o, st = t.generate(18, seed=8)
    oj, stj = j.generate(18, seed=8)
    np.testing.assert_array_equal(o, oj)
    np.testing.assert_array_equal(st, stj)
    before = t.predict(o)
    t.train(o, max_iter=40, error=1e-4)
    j.train(o, max_iter=40, error=1e-4)
    for a, b in ((t.pi, j.pi), (t.A, j.A), (t.B, j.B)):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert t.predict(o) >= before
    np.testing.assert_allclose(t.predict(o), j.predict(o), rtol=1e-4)
    np.testing.assert_array_equal(t.decode(o)[0], j.decode(o)[0])


# --------------------------------------------------------------- HPSSNMF

@pytest.mark.parametrize("tp", [0, 2])
def test_hpss_nmf_matches_jax(tp):
    """The NMF separation of a seeded tone + clicks against JAX at 1e-4
    of the input's peak (fp32 products on both sides), and h + p
    reconstructs the input inside."""
    rng = np.random.default_rng(12)
    n = 24000
    x = 0.5 * np.sin(2 * np.pi * 262 * np.arange(n) / 32000)
    for pos in range(1500, n - 1500, 5000):
        x[pos:pos + 48] += 0.9 * rng.standard_normal(48)
    x = (x + 0.01 * rng.standard_normal(n)).astype(np.float32)
    kw = dict(radix2_exp=11, slide_length=512, k=6, max_iter=60, tp=tp)
    t, j = aft.HPSSNMF(**kw, **CPU), af.HPSSNMF(**kw)
    h, p = (_np(a) for a in t.hpss(x, seed=2))
    hj, pj = (np.asarray(a) for a in j.hpss(x, seed=2))
    peak = float(np.abs(x).max())
    assert h.shape == hj.shape
    assert np.abs(h - hj).max() <= 1e-4 * peak
    assert np.abs(p - pj).max() <= 1e-4 * peak
    N = t.fft_length
    m = len(h)
    assert np.abs(h + p - x[:m])[N:-N].max() <= 1e-3 * peak
    assert t.cal_time_length(n) == j.cal_time_length(n)
    with pytest.raises(ValueError):
        t.hpss(np.stack([x, x]))


def test_device_policy():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: aft.NMF(4), lambda: aft.HMM(3, 3),
                 lambda: aft.HPSSNMF(), lambda: aft.nmf(np.ones((4, 4)), 2),
                 lambda: aft.viterbi(np.ones(2) / 2, np.eye(2),
                                     np.eye(2))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
