"""The port's pipeline, batch runner and dry run on the CPU mesh: the
pipeline against the direct composition (rtol 2e-6, the JAX dry run's),
the runner's files against its arrays and its exactly-once restart, and
``dryrun_multichip`` on eight CPU shards."""

import json
import os

import numpy as np
import pytest
import torch

import audioflux_torch as aft
from audioflux_torch.io.wave import write as wav_write
from audioflux_torch.observe import metrics
from audioflux_torch.parallel import BatchRunner, make_mesh, pipeline_chain_fn
from audioflux_torch.parallel.dryrun import dryrun_multichip

CPU8 = [torch.device("cpu")] * 8


def _chain():
    win = torch.from_numpy(np.hanning(128).astype(np.float32))
    fb = torch.from_numpy(np.abs(np.random.default_rng(2).standard_normal(
        (65, 16))).astype(np.float32))
    ops = [
        lambda v: v.reshape(v.shape[0], 4, 128) * win,
        lambda v: torch.fft.rfft(v, dim=-1).abs() ** 2,
        lambda v: v @ fb,
        lambda v: torch.log10(v + 1.0),
    ]
    shapes = [(512,), (4, 128), (4, 65), (4, 16), (4, 16)]
    return ops, shapes


@pytest.mark.parametrize("n_micro", [1, 2, 4, 8])
def test_pipeline_matches_composition(n_micro):
    ops, shapes = _chain()
    mesh = make_mesh(data=2, time=4, devices=CPU8)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (16, 512)).astype(np.float32))
    got = pipeline_chain_fn(ops, shapes, mesh, axis="time",
                            n_micro=n_micro)(x)
    want = x
    for op in ops:
        want = op(want)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-6)


def test_pipeline_two_stages_over_data_axis():
    ops, shapes = _chain()
    stages = [lambda v: ops[1](ops[0](v)), lambda v: ops[3](ops[2](v))]
    mesh = make_mesh(data=2, time=4, devices=CPU8)
    x = np.random.default_rng(5).standard_normal((6, 512)).astype(np.float32)
    got = pipeline_chain_fn(stages, [shapes[0], shapes[2], shapes[4]], mesh,
                            axis="data", n_micro=3)(x)
    want = stages[1](stages[0](torch.from_numpy(x)))
    torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-6)


def test_pipeline_errors():
    ops, shapes = _chain()
    mesh = make_mesh(data=2, time=4, devices=CPU8)
    with pytest.raises(ValueError, match="chain has 3 stages"):
        pipeline_chain_fn(ops[:3], shapes[:4], mesh)
    with pytest.raises(ValueError, match="stage_shapes"):
        pipeline_chain_fn(ops, shapes[:4], mesh)
    run = pipeline_chain_fn(ops, shapes, mesh, n_micro=4)
    with pytest.raises(ValueError, match="not divisible"):
        run(np.zeros((6, 512), np.float32))
    bad = pipeline_chain_fn(ops, [(512,), (4, 128), (4, 64), (4, 16),
                                  (4, 16)], mesh)
    with pytest.raises(ValueError, match="stage 1 gave"):
        bad(np.zeros((4, 512), np.float32))


def _wavs(tmp_path, n_files, clip):
    paths = []
    for i in range(n_files):
        t = np.arange(clip) / 32000
        x = (0.4 * np.sin(2 * np.pi * (200 + 100 * i) * t)).astype(np.float32)
        p = tmp_path / f"c{i}.wav"
        wav_write(str(p), x, 32000)
        paths.append(str(p))
    return paths


@pytest.fixture()
def runner():
    mesh = make_mesh(data=2, time=4, devices=CPU8)
    plan = aft.MelSpectrogram(num=32, samplate=32000, radix2_exp=10,
                              slide_length=256, device="cpu")
    return BatchRunner(plan, mesh, clip_length=256 * 4 * 16, with_xxcc=13)


def test_batch_runner_files_vs_array(tmp_path, runner):
    clip = runner.clip_length
    paths = _wavs(tmp_path, 4, clip)
    metrics.reset()
    (spec, cc), good = runner.run_files(paths)
    assert good == 4
    T = (clip - 1024) // 256 + 1
    assert tuple(spec.shape) == (4, 32, T) and tuple(cc.shape) == (4, 13, T)
    decoded = np.stack([aft.read(p)[0] for p in paths])
    spec2, cc2 = runner.run_array(decoded)
    assert torch.equal(spec, spec2) and torch.equal(cc, cc2)
    rep = metrics.report()
    assert rep["af.load_batch.calls"] == 1 and rep["af.clips"] == 8
    with pytest.raises(ValueError, match="divisible"):
        BatchRunner(runner.plan, runner.mesh, clip_length=clip + 256)


def test_batch_runner_resumable_exactly_once(tmp_path, runner):
    paths = _wavs(tmp_path, 5, runner.clip_length)
    out = tmp_path / "out"
    n1, s1 = runner.run_files_resumable(paths, str(out), max_chunks=1)
    assert (n1, s1) == (2, 0)
    n2, s2 = runner.run_files_resumable(paths, str(out))
    assert (n2, s2) == (3, 2)
    n3, s3 = runner.run_files_resumable(paths, str(out))
    assert (n3, s3) == (0, 5)
    with open(out / "manifest.jsonl") as f:
        done = [json.loads(line)["path"] for line in f if line.strip()]
    assert sorted(done) == sorted(paths) and len(done) == len(set(done))
    for lo in (0, 2):       # the chunks as they ran: two files each
        (spec, _), _ = runner.run_files(paths[lo:lo + 2])
        for i, p in enumerate(paths[lo:lo + 2]):
            base = os.path.splitext(os.path.basename(p))[0]
            np.testing.assert_array_equal(np.load(out / f"{base}.npy"),
                                          spec[i].numpy())


@pytest.mark.parametrize("n", [8, 2])
def test_dryrun_multichip_cpu(n):
    dryrun_multichip(n, devices=[torch.device("cpu")] * n)
