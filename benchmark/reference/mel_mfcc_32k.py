"""Plain reference of ``mel_mfcc_32k``: frames -> periodic Hann window ->
real DFT -> power -> mel bank -> log10(max(mel, 1e-8)) -> orthonormal
DCT-II, the first ``cc_num`` rows.  Both outputs (clips, num, T) and
(clips, cc_num, T), as the configuration's entry returns them.
"""

from __future__ import annotations

import torch

from benchmark.reference import common

FRAMES_PER_BLOCK = 32768


class Reference:
    def __init__(self, cfg: dict, device):
        p = cfg["plans"]["mel"]
        self.n_fft = 1 << p["radix2_exp"]
        self.slide = p["slide_length"]
        self.cc_num = cfg["entry_args"]["cc_num"]
        self.device = torch.device(device)
        self.window = torch.from_numpy(common.fft_window("hann", self.n_fft))
        self.bank = torch.from_numpy(common.mel_filter_bank(
            p["num"], self.n_fft, p["samplate"])).double()
        self.dct = torch.from_numpy(common.dct_matrix(p["num"])[:self.cc_num])

    def run(self, x: torch.Tensor, precision: str = "float64") -> dict:
        """x (clips, n) float32 -> {"mel", "mfcc"} in the precision's
        dtype, on x's device."""
        prec = common.Precision(precision)
        dev, dt = x.device, prec.dtype
        win = self.window.to(dev, dt)
        bank_t = self.bank.to(dev, dt).T.contiguous()
        dct_t = self.dct.to(dev, dt).T.contiguous()
        clips, n = x.shape
        t = common.n_frames(n, self.n_fft, self.slide)
        mel = torch.empty((clips, bank_t.shape[1], t), dtype=dt, device=dev)
        cc = torch.empty((clips, self.cc_num, t), dtype=dt, device=dev)
        per = max(1, FRAMES_PER_BLOCK // t)
        for c0 in range(0, clips, per):
            c1 = min(c0 + per, clips)
            fr = torch.stack([common.frames(x[c].to(dt), self.n_fft, self.slide)
                              for c in range(c0, c1)])
            fr = prec.q(prec.q(fr) * win)
            spec = prec.q(torch.fft.rfft(fr, dim=-1))
            power = prec.q(spec.real.square() + spec.imag.square())
            m = prec.matmul(power, bank_t)
            logm = prec.q(torch.log10(torch.clamp(m, min=1e-8)))
            c = prec.matmul(logm, dct_t)
            mel[c0:c1] = m.transpose(-1, -2)
            cc[c0:c1] = c.transpose(-1, -2)
        return {"mel": mel, "mfcc": cc}


def compare(got: dict, ref: dict) -> dict:
    """The numbers ``correct`` is decided on: for each output, the widest
    gap over the clips of max |got - ref| / max |ref| in the clip."""
    return {"mel_gap": common.peak_share(got["mel"], ref["mel"]),
            "mfcc_gap": common.peak_share(got["mfcc"], ref["mfcc"])}
