"""The one generator of requests.  A workload's data file names a signal,
the request's shape, how many distinct requests the pool holds, and where
they live; this module makes that pool from the seed, on the device and in
a few large calls.

Keys of ``workloads/<cell>.json`` read here:

- ``signal``: ``noise`` (Gaussian, ``scale``) or ``mir`` (per clip a tone
  with vibrato and one overtone, so that YIN finds real troughs; a click
  train, so that HPSS and the onsets have a percussive part; low noise);
- ``samplate``, ``batch`` (null for one clip a request), ``samples``;
- ``pool``: distinct requests, used in turn;
- ``io``: ``device`` (float32 tensors on the card) or ``host`` (float32
  numpy arrays in host memory, uploaded by the program's entry).

The harness reads the rest: ``config``; ``keep``, how many calls'
results a run samples for the check; ``trace_calls``, how many calls a
``--trace 1`` run profiles.
"""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def noise(shape, gen, device, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device) * scale


def mir(shape, gen, device, samplate: int) -> torch.Tensor:
    """(clips, n) test audio; the draws are a copy of the repo's
    ``chip_smoke.py`` ``mir_signal``."""
    clips, n = shape

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((clips, 1), generator=gen,
                                           device=device)

    t = torch.arange(n, device=device, dtype=torch.float32) / samplate
    f0, rate, depth = u(110.0, 880.0), u(4.0, 7.0), u(0.002, 0.01)
    ph = 2 * math.pi * (f0 * t + depth * f0 / (2 * math.pi * rate)
                        * torch.sin(2 * math.pi * rate * t))
    x = 0.4 * torch.sin(ph) + 0.15 * torch.sin(2 * ph)
    del ph
    period = (u(0.3, 0.7) * samplate).long()
    idx = torch.arange(n, device=device)
    clicks = ((idx % period) < 64).to(torch.float32)
    x += clicks * noise((clips, n), gen, device, 0.6)
    x += noise((clips, n), gen, device, 0.01)
    return x


def request_shape(wl: dict) -> tuple:
    return ((wl["samples"],) if wl.get("batch") is None
            else (wl["batch"], wl["samples"]))


def audio_seconds(wl: dict) -> float:
    """Seconds of audio in one request."""
    return (wl.get("batch") or 1) * wl["samples"] / wl["samplate"]


def make_pool(wl: dict, seed: int, device) -> list:
    """The workload's ``pool`` distinct requests, drawn from ``seed``."""
    gen = generator(seed, device)
    shape = request_shape(wl)
    rows = (1,) + shape if len(shape) == 1 else shape
    pool = []
    for _ in range(wl["pool"]):
        if wl["signal"] == "noise":
            x = noise(rows, gen, device, wl["scale"])
        elif wl["signal"] == "mir":
            x = mir(rows, gen, device, wl["samplate"])
        else:
            raise ValueError(f"unknown signal {wl['signal']!r}")
        x = x.reshape(shape).contiguous()
        pool.append(x.cpu().numpy() if wl["io"] == "host" else x)
    return pool
