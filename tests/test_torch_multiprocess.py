"""The port's multi-process path: two OS processes over a localhost
rendezvous on gloo, the ``data`` axis split between them (two rows each)
and ``time=4`` inside each.  The gathered sharded mel+MFCC is held to the
JAX package's single-process result, as tests/test_multihost.py holds its
own two-process run."""

import os
import socket
import subprocess
import sys

import numpy as np

import audioflux_tpu as af

_WORKER = r"""
import sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
out = sys.argv[4]
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
from audioflux_torch.parallel import distributed, make_mesh
from audioflux_torch.parallel.sharded import sharded_spectrogram_fn
from audioflux_torch.transforms.spectrogram import MelSpectrogram

distributed.initialize(coordinator_address="localhost:" + port,
                       num_processes=nproc, process_id=pid,
                       backend="gloo")
assert distributed.is_initialized() and distributed.backend() == "gloo"
mesh = make_mesh(data=1, time=4, devices=[torch.device("cpu")] * 4)
plan = MelSpectrogram(num=32, samplate=32000, radix2_exp=10,
                      slide_length=256, device="cpu")
fn = sharded_spectrogram_fn(plan, mesh, with_xxcc=5)
rng = np.random.default_rng(0)
full = (rng.standard_normal((4, 8192)) * 0.2).astype(np.float32)
local = full[pid * 2:(pid + 1) * 2]
x = distributed.global_from_local(local, mesh, ("data", "time"))
spec, cc = fn(x)
spec_g = distributed.process_allgather(spec, tiled=True)
cc_g = distributed.process_allgather(cc, tiled=True)
distributed.process_barrier()
if pid == 0:
    np.savez(out, spec=spec_g.numpy(), cc=cc_g.numpy())
    print("MULTIPROCESS_OK")
"""


def test_two_process_gloo_equals_jax_single(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER % {"repo": os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))})
    out = tmp_path / "gathered.npz"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", str(port), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        try:
            o, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            o, _ = p.communicate()
        outs.append(o)
    assert procs[0].returncode == 0, outs[0][-2000:]
    assert procs[1].returncode == 0, outs[1][-2000:]
    assert "MULTIPROCESS_OK" in outs[0], outs[0][-2000:]
    assert "backend gloo (named by the caller)" in outs[1]

    got = np.load(out)
    rng = np.random.default_rng(0)
    full = (rng.standard_normal((4, 8192)) * 0.2).astype(np.float32)
    plan = af.MelSpectrogram(num=32, samplate=32000, radix2_exp=10,
                             slide_length=256)
    ref_spec = np.asarray(plan.spectrogram(full))
    ref_cc = np.asarray(plan.mfcc(ref_spec, 5))
    assert got["spec"].shape == ref_spec.shape
    assert np.abs(got["spec"] - ref_spec).max() <= 1e-4 * np.abs(ref_spec).max()
    assert np.abs(got["cc"] - ref_cc).max() <= 1e-4 * np.abs(ref_cc).max()
