"""The entry of ``mir_pipeline_32k``, the calls in the order a user writes
them: ``PitchYIN.pitch``; ``MelSpectrogram.spectrogram`` into
``Spectral.flux``; each recording's envelope fetched, shifted, scaled and
peak-picked on the host with ``Onset``'s windows; ``HPSS.hpss``.  The call
returns once pitch, h and p are finished on the card and the onset points
are on the host."""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch import HPSS, MelSpectrogram, WindowType
from audioflux_torch.features.spectral import Spectral
from audioflux_torch.mir.onset import Onset, peak_pick
from audioflux_torch.mir.pitch_yin import PitchYIN


class Entry:
    def __init__(self, cfg: dict, device):
        p = cfg["plans"]
        y, m, o, h = p["yin"], p["mel"], p["onset"], p["hpss"]
        self.device = torch.device(device)
        self.yin = PitchYIN(samplate=y["samplate"], low_fre=y["low_fre"],
                            high_fre=y["high_fre"], radix2_exp=y["radix2_exp"],
                            slide_length=y["slide_length"],
                            auto_length=y["auto_length"], device=device)
        self.yin.set_thresh(y["thresh"])
        self.mel = MelSpectrogram(num=m["num"], samplate=m["samplate"],
                                  radix2_exp=m["radix2_exp"],
                                  slide_length=m["slide_length"], device=device)
        self.spectral = Spectral(m["num"], np.zeros(m["num"], np.float32),
                                 device=device)
        self.flux = p["flux"]
        self.onset = Onset(time_length=o["time_length"],
                           fre_length=o["fre_length"],
                           slide_length=o["slide_length"],
                           samplate=o["samplate"], device=device)
        self.hpss = HPSS(radix2_exp=h["radix2_exp"],
                         window_type=WindowType[h["window_type"]],
                         slide_length=h["slide_length"], h_order=h["h_order"],
                         p_order=h["p_order"], device=device)

    def _points(self, env):
        on, out = self.onset, []
        for row in env.astype(np.float32):
            row = row - row.min()
            mx = row.max()
            if mx > 0:
                row = row / mx
            out.append(peak_pick(row, on.pre_max, on.post_max, on.pre_avg,
                                 on.post_avg, on.wait, on.delta))
        return out

    def call(self, x, spans) -> dict:
        f = self.flux
        with spans.span("yin"):
            pitch, _ = self.yin.pitch(x)
        with spans.span("flux"):
            env = self.spectral.flux(self.mel.spectrogram(x), step=f["step"],
                                     p=f["p"], is_positive=bool(f["is_positive"]),
                                     is_exp=bool(f["is_exp"]), tp=f["tp"])
        with spans.span("fetch"):  # waits for YIN and the flux on the card
            env_host = env.cpu().numpy()
        with spans.span("host_stage"):
            points = self._points(env_host)
        with spans.span("hpss"):
            h, p = self.hpss.hpss(x)
        with spans.span("sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return {"pitch": pitch, "env": env, "points": points, "h": h, "p": p}
