"""The entry of ``pitch_track_32k``, the calls in the order a user writes
them: ``PitchNCF.pitch``, ``PitchHPS.pitch``, ``PitchPEF.pitch``,
``HarmonicRatio.harmonic_ratio``, each under a span of its own.  The call
returns once the four (rows, T) float32 tracks are finished on the card;
nothing leaves the card inside it."""

from __future__ import annotations

import torch

from audioflux_torch import WindowType
from audioflux_torch.mir.harmonic_ratio import HarmonicRatio
from audioflux_torch.mir.pitch import PitchHPS, PitchNCF, PitchPEF


def _common(p: dict, device) -> dict:
    return dict(samplate=p["samplate"], radix2_exp=p["radix2_exp"],
                slide_length=p["slide_length"],
                window_type=WindowType[p["window_type"]], device=device)


class Entry:
    def __init__(self, cfg: dict, device):
        p = cfg["plans"]
        n, h, f = p["ncf"], p["hps"], p["pef"]
        self.device = torch.device(device)
        self.ncf = PitchNCF(low_fre=n["low_fre"], high_fre=n["high_fre"],
                            **_common(n, device))
        self.hps = PitchHPS(low_fre=h["low_fre"], high_fre=h["high_fre"],
                            harmonic_count=h["harmonic_count"],
                            **_common(h, device))
        self.pef = PitchPEF(low_fre=f["low_fre"], high_fre=f["high_fre"],
                            cut_fre=f["cut_fre"], alpha=f["alpha"],
                            beta=f["beta"], gamma=f["gamma"],
                            **_common(f, device))
        self.hr = HarmonicRatio(low_fre=p["hr"]["low_fre"],
                                **_common(p["hr"], device))

    def call(self, x, spans) -> dict:
        with spans.span("ncf"):
            ncf = self.ncf.pitch(x)
        with spans.span("hps"):
            hps = self.hps.pitch(x)
        with spans.span("pef"):
            pef = self.pef.pitch(x)
        with spans.span("hr"):
            hr = self.hr.harmonic_ratio(x)
        with spans.span("sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return {"ncf": ncf, "hps": hps, "pef": pef, "hr": hr}
