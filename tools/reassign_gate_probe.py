"""Probe config 3's reassigned-BFT gate over many random draws on one CUDA
card: ``BFT(num=128, radix2_exp=12, slide 1024, LINEAR, POWER,
is_reassign=True).bft(x, result_type=1)`` on the card and on the CPU for
1000 clips of 4096 samples (``chip_smoke.py`` 3d's server rows) a draw,
and for each draw the cells that moved between the two, classified by
``chip_smoke.reassign_edges`` (the float64 run of the port's own code):

    python3 tools/reassign_gate_probe.py [--draws N] [--seed S]

Prints the card (``nvidia-smi`` name and power limit), one line a draw
(source cells moved and on an edge, flipped band cells and how many lie
away from an edge, the mass over all cells and over the cells no edge
touches, and the old gate's flips and mass on the first and last 8
clips, the cells ``chip_smoke.py`` compared before), every flipped cell
with its source cells, and a JSON line of the totals.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=16)
    ap.add_argument("--seed", type=int, default=1400)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script compares the card")
    import chip_smoke as cs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    kw = dict(num=128, radix2_exp=cs.C3_R2E, samplate=cs.SR,
              slide_length=cs.C3_SLIDE,
              scale_type=cs.SpectralFilterBankScaleType.LINEAR,
              data_type=cs.SpectralDataType.POWER, is_reassign=True)
    rb, rc = cs.BFT(**kw, device="cuda"), cs.BFT(**kw, device="cpu")
    ends = list(range(8)) + list(range(cs.C3_CLIPS - 8, cs.C3_CLIPS))
    totals = dict(draws=0, moved=0, on_edge=0, flipped=0, away=0,
                  old_gate_failed=0)
    for d in range(args.draws):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed + d)
        xs = cs.randn((cs.C3_CLIPS, cs.C3_N), gen, 0.2)
        got = rb.bft(xs, result_type=1).cpu()
        x_cpu = xs.cpu()
        ref = rc.bft(x_cpu, result_type=1)
        e = cs.reassign_edges(got, ref, rb, xs, x_cpu)
        # the old gate on chip_smoke's 16 clips
        g, r = got[ends].abs().double(), ref[ends].abs().double()
        flips16 = float(((g - r).abs() > cs.RE_FLIP_TOL * float(r.max()))
                        .double().mean())
        mass16 = abs(float(g.sum()) / float(r.sum()) - 1)
        old_ok = flips16 <= cs.FLIP_SHARE and mass16 <= cs.MASS_TOL
        away = sum(1 for c in e["flipped"] if not c["on_edge"])
        print(f"draw {args.seed + d}: {e['moved']} source cells moved, "
              f"{e['on_edge']} on an edge; {len(e['flipped'])} flipped band "
              f"cells, {away} away from an edge; mass {e['mass_all']:.3e} "
              f"(off-edge cells {e['mass']:.3e}); the old gate on 16 clips: "
              f"flips {flips16:.3e}, mass {mass16:.3e}"
              f"{'' if old_ok else ' FAILS'}", flush=True)
        cs.print_reassign_edges(f"draw {args.seed + d}", e)
        for k, v in (("draws", 1), ("moved", e["moved"]),
                     ("on_edge", e["on_edge"]),
                     ("flipped", len(e["flipped"])), ("away", away),
                     ("old_gate_failed", int(not old_ok))):
            totals[k] += v
    print(json.dumps(dict(card=smi, **totals)))


if __name__ == "__main__":
    main()
