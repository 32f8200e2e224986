"""The entry of ``mel_mfcc_32k``: ``MelSpectrogram.spectrogram_mfcc_fused``.

A request on the device returns device tensors once the card has finished
them; a request in host memory (numpy) returns numpy arrays in host memory,
as a feature server hands them on."""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch import MelSpectrogram


class Entry:
    def __init__(self, cfg: dict, device):
        p = cfg["plans"]["mel"]
        self.plan = MelSpectrogram(num=p["num"], samplate=p["samplate"],
                                   radix2_exp=p["radix2_exp"],
                                   slide_length=p["slide_length"],
                                   device=device)
        self.cc_num = cfg["entry_args"]["cc_num"]
        self.device = torch.device(device)

    def call(self, x, spans) -> dict:
        with spans.span("issue"):
            mel, cc = self.plan.spectrogram_mfcc_fused(x, cc_num=self.cc_num)
        if isinstance(x, np.ndarray):
            with spans.span("fetch"):
                return {"mel": mel.cpu().numpy(), "mfcc": cc.cpu().numpy()}
        with spans.span("sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return {"mel": mel, "mfcc": cc}
