"""The entry of ``cwt_synsq_32k``, as upstream ``synsq.py``'s usage writes
it: ``W = CWT(...).cwt(x)``, then ``Synsq(...).synsq(W, OCTAVE, fre)``
with the CWT's band frequencies.  The call returns once both are finished
on the card; both outputs are (clips, num, n) complex64.

The band frequencies are uploaded once, here: handed as a numpy array,
``Synsq.synsq`` would upload them on every call."""

from __future__ import annotations

import torch

from audioflux_torch import (CWT, SpectralFilterBankScaleType, Synsq,
                             WaveletContinueType)


class Entry:
    def __init__(self, cfg: dict, device):
        c, s = cfg["plans"]["cwt"], cfg["plans"]["synsq"]
        self.device = torch.device(device)
        self.scale = SpectralFilterBankScaleType[c["scale"]]
        self.cwt = CWT(num=c["num"], radix2_exp=c["radix2_exp"],
                       samplate=c["samplate"], low_fre=c["low_fre"],
                       bin_per_octave=c["bin_per_octave"],
                       wavelet_type=WaveletContinueType[c["wavelet"]],
                       scale_type=self.scale, gamma=c["gamma"],
                       beta=c["beta"], is_padding=c["is_padding"],
                       device=device)
        self.synsq = Synsq(num=s["num"], radix2_exp=s["radix2_exp"],
                           samplate=s["samplate"], order=s["order"],
                           thresh=s["thresh"], device=device)
        self.fre = torch.as_tensor(self.cwt.get_fre_band_arr(),
                                   device=self.device)

    def call(self, x, spans) -> dict:
        with spans.span("cwt"):
            w = self.cwt.cwt(x)
        with spans.span("synsq"):
            s = self.synsq.synsq(w, self.scale, self.fre)
        with spans.span("sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return {"cwt": w, "synsq": s}
