"""The entry of ``cqt_chroma_32k``, as upstream's ``cqt.py`` usage writes
it: ``C = CQT(...).cqt(x)``, then ``cqt.chroma(C, ...)``, each under a
span of its own.  The call returns once both are finished on the card:
the CQT as (clips, num, T, 2) float32 real pairs (``torch.view_as_real``
of the complex64 output, a view, so that a control's float32 outputs
carry the imaginary parts too) and the chroma as (clips, chroma_num, T)
float32."""

from __future__ import annotations

import torch

from audioflux_torch import (CQT, ChromaDataNormalType, SpectralDataType,
                             SpectralFilterBankNormalType, WindowType)


class Entry:
    def __init__(self, cfg: dict, device):
        c, h = cfg["plans"]["cqt"], cfg["plans"]["chroma"]
        self.device = torch.device(device)
        self.cqt = CQT(num=c["num"], samplate=c["samplate"],
                       low_fre=c["low_fre"],
                       bin_per_octave=c["bin_per_octave"],
                       factor=c["factor"], beta=c["beta"],
                       thresh=c["thresh"],
                       window_type=WindowType[c["window_type"]],
                       slide_length=c["slide_length"],
                       normal_type=SpectralFilterBankNormalType[
                           c["normal_type"]],
                       is_scale=c["is_scale"], device=device)
        self.chroma_args = dict(
            chroma_num=h["chroma_num"],
            data_type=SpectralDataType[h["data_type"]],
            norm_type=ChromaDataNormalType[h["norm_type"]])

    def call(self, x, spans) -> dict:
        with spans.span("cqt"):
            c = self.cqt.cqt(x)
        with spans.span("chroma"):
            chroma = self.cqt.chroma(c, **self.chroma_args)
        with spans.span("sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return {"cqt": torch.view_as_real(c), "chroma": chroma}
