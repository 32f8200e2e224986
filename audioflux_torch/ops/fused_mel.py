"""Fused mel spectrogram + cepstral coefficients: the CUDA kernel
``csrc/fused_mel_mfcc.cu`` and its plain PyTorch version.

Counterpart of ``audioflux_tpu/ops/pallas_spectrogram.py``
(``FusedMelPlan``, ``fused_mel_mfcc``).  It computes what the Pallas
kernel computes — framing, window, real FFT, power, a power-domain
filterbank (mel), then the DCT-II of ``log10(max(mel, 1e-8))`` — and
owes none of that kernel's TPU layout variants.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from audioflux_torch.observe import scope
from audioflux_torch.ops import _build
from audioflux_torch.ops.backend import as_tensor, require_sm90, resolve_device
from audioflux_torch.ops.cuda_fft import twiddle_table
from audioflux_torch.ops.frame import frame_signal

__all__ = ["FusedMelPlan", "fused_mel_mfcc", "fused_mel_mfcc_ref"]

_MAX_LOG2_FFT = 14             # one n_fft-point complex transform in shared memory
_SMEM_TARGET = 110 * 1024      # the kernel of the passes: two blocks per SM
_SMEM_MAX = 232448             # the most a block may have on sm_90
# n_fft of the register-resident kernel -> (A, B, C1): n_fft = A * B, a group
# of T = B / C1 threads owns a frame pair (csrc/fused_mel_mfcc.cu)
_REG_SPLIT = {512: (32, 16, 1), 1024: (32, 32, 2), 2048: (64, 32, 1),
              4096: (64, 64, 1)}


class FusedMelPlan:
    """Device constants for the fused kernel.

    ``window`` (n_fft,), ``mel_fb`` (num_mel, n_fft//2+1) power-domain
    filterbank, ``dct`` (cc_num, num_mel) DCT-II rows, on ``device``
    (``None`` -> ``cuda``).  Needs slide | n_fft and 128 | slide, as the TPU
    plan does.
    """

    def __init__(self, window, mel_fb, dct, slide_length: int, device=None):
        window = np.asarray(window, np.float32)
        mel_fb = np.asarray(mel_fb, np.float32)
        dct = np.asarray(dct, np.float32)
        self.n_fft = int(window.shape[0])
        self.slide = int(slide_length)
        if self.slide <= 0 or self.n_fft % self.slide:
            raise ValueError("fused kernel needs slide | fft")
        if self.slide % 128:
            raise ValueError("fused kernel needs 128 | slide")
        self.num_mel = int(mel_fb.shape[0])
        self.cc_num = int(dct.shape[0])
        if mel_fb.shape[1] != self.n_fft // 2 + 1:
            raise ValueError(f"mel_fb must have n_fft//2+1 = "
                             f"{self.n_fft // 2 + 1} columns")
        if dct.shape[1] != self.num_mel:
            raise ValueError(f"dct must have num_mel = {self.num_mel} columns")
        self.device = resolve_device(device)
        dev = self.device
        self.window = torch.from_numpy(window).to(dev)
        self.mel_fb = torch.from_numpy(mel_fb).to(dev)
        self.dct = torch.from_numpy(dct).to(dev)

        # each band's nonzero bin range [lo, lo+len), its weights packed
        nz = mel_fb != 0
        any_nz = nz.any(axis=1)
        lo = np.where(any_nz, np.argmax(nz, axis=1), 0)
        hi = np.where(any_nz, nz.shape[1] - np.argmax(nz[:, ::-1], axis=1), 0)
        length = hi - lo
        off = np.concatenate([[0], np.cumsum(length)[:-1]])
        packed = np.concatenate(
            [mel_fb[m, lo[m]:hi[m]] for m in range(self.num_mel)]
            + [np.zeros(1, np.float32)])
        self.band_lo = torch.from_numpy(lo.astype(np.int32)).to(dev)
        self.band_len = torch.from_numpy(length.astype(np.int32)).to(dev)
        self.band_off = torch.from_numpy(off.astype(np.int32)).to(dev)
        self.band_w = torch.from_numpy(packed.astype(np.float32)).to(dev)
        self.band_nnz = int(length.sum())


def fused_mel_mfcc_ref(plan: FusedMelPlan, x: torch.Tensor):
    """Plain version: unfold -> window -> ``torch.fft.rfft`` -> power ->
    matmul -> log10 -> matmul.  (..., n) -> (..., num, T), (..., cc, T)."""
    frames = frame_signal(x, plan.n_fft, plan.slide) * plan.window
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real.square() + spec.imag.square()
    mel = torch.matmul(power, plan.mel_fb.T)
    cc = torch.matmul(torch.log10(torch.clamp(mel, min=1e-8)), plan.dct.T)
    return (mel.transpose(-1, -2).contiguous(),
            cc.transpose(-1, -2).contiguous())


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("fused_mel_mfcc").af_fused_mel_mfcc
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, ll, ll, i, i, i, p, p, p, p, p, p, i, p, i, i, p, p,
                   i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _launch_shape(n_fft: int, num: int, slide: int) -> dict:
    """The kernel's launch shape, a pure function of the plan's sizes.

    ``registers=True`` (n_fft 512 to 4096): the register-resident
    kernel; ``threads`` a block (the most of 256, 128, 64, 32 that fits),
    ``tile = 2 * threads / T`` >= 4 frames, ``smem`` bytes without the optional
    constants (band weights and DCT rows, which :func:`_launch` adds when
    they fit).  Otherwise the kernel of the shared-memory passes: ``tile``
    frames per block, ``np`` frame pairs per round (np * n_fft / 16
    threads, about 512, at most 1024), ``staged`` holds the tile's audio
    span in shared memory; the first fit, staged before unstaged, more
    pairs and then larger tiles first, under the two-blocks-per-SM target,
    else under the per-block limit."""
    if n_fft in _REG_SPLIT:
        _, b, c1 = _REG_SPLIT[n_fft]
        group = b // c1
        a = _REG_SPLIT[n_fft][0]
        # a pair's transpose buffer (reg_ex_words of the source)
        ex = max(a * (b + 1), 2 * group * (b // 2 + 1) if group == a else 0)
        for threads in (256, 128, 64, 32):
            tile = 2 * threads // group
            span = (tile * slide + n_fft - slide + 3) // 4 * 4
            # span, twiddles + window, the powers (bin-major, tile + 4
            # apart), the pairs' transpose buffers (later mel and log-mel)
            smem = 4 * (span + 3 * n_fft + (n_fft // 2 + 1) * (tile + 4)
                        + max(threads // group * ex, num * (2 * tile + 4)))
            if tile >= 4 and smem <= _SMEM_MAX:
                return dict(registers=True, threads=threads, tile=tile,
                            group=group, smem=smem)
    stride = n_fft + n_fft // 16 + 4  # padded transform (fft_smem.cuh)
    for limit in (_SMEM_TARGET, _SMEM_MAX):
        for staged in (1, 0):
            np_ = max(1, min(8, 8192 // n_fft))
            while np_ >= 1:
                for tile in (16, 8, 4, 2):
                    span = (tile * slide + n_fft - slide) if staged else 0
                    smem = 8 * stride * np_ + 4 * (2 * tile * num + span)
                    if tile >= 2 * np_ and smem <= limit:
                        return dict(registers=False, tile=tile, np=np_,
                                    staged=staged, smem=smem,
                                    threads=max(1, np_ * n_fft // 16))
                np_ //= 2
    raise ValueError(f"n_fft={n_fft}, num={num} do not fit shared memory")


def _launch(plan: FusedMelPlan, x: torch.Tensor, n_frames: int,
            stages: int = 4):
    """Run the kernel on contiguous (batch, n) CUDA audio.  ``stages`` < 4
    cuts the register-resident kernel after a stage (1 load + window +
    first pass, 2 second pass + power, 3 filterbank + log10; the outputs
    are then not mel and cc) to time the stages apart."""
    if plan.n_fft & (plan.n_fft - 1) or plan.n_fft.bit_length() - 1 > _MAX_LOG2_FFT:
        raise ValueError(f"the fused kernel needs pow2 n_fft <= "
                         f"{1 << _MAX_LOG2_FFT}, got {plan.n_fft}")
    shape = _launch_shape(plan.n_fft, plan.num_mel, plan.slide)
    if stages != 4 and not shape["registers"]:
        raise ValueError("the timing cuts exist in the register-resident "
                         "kernel only (n_fft 512 to 4096)")
    require_sm90(x.device)
    batch, n = x.shape
    mel = torch.empty((batch, plan.num_mel, n_frames), dtype=torch.float32,
                      device=x.device)
    cc = torch.empty((batch, plan.cc_num, n_frames), dtype=torch.float32,
                     device=x.device)
    if batch == 0:
        return mel, cc
    n_w = plan.band_w.numel()
    consts = 4 * (n_w + plan.cc_num * plan.num_mel)
    consts_smem = int(shape["registers"] and shape["smem"] + consts <= _SMEM_MAX)
    tw = twiddle_table(plan.n_fft, x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), batch, n, n_frames, plan.slide,
                 plan.n_fft.bit_length() - 1, plan.window.data_ptr(),
                 tw.data_ptr(), plan.band_lo.data_ptr(),
                 plan.band_len.data_ptr(), plan.band_off.data_ptr(),
                 plan.band_w.data_ptr(), n_w, plan.dct.data_ptr(),
                 plan.num_mel, plan.cc_num, mel.data_ptr(), cc.data_ptr(),
                 int(shape["registers"]), shape["threads"], consts_smem,
                 stages, shape["tile"], shape.get("np", 0),
                 shape.get("staged", 0), stream)
    if err:
        raise RuntimeError(f"fused_mel_mfcc launch failed: CUDA error {err}")
    fused_mel_mfcc.launches += 1
    return mel, cc


def fused_mel_mfcc(plan: FusedMelPlan, x, fast: bool = False):
    """(..., n) audio -> (..., num_mel, T), (..., cc_num, T), any T >= 1.

    A CUDA tensor launches the kernel (sm_90 only) or raises; a CPU tensor
    takes the plain version; host data is uploaded to the plan's device.
    ``fast`` (the TPU kernel's bf16x3 mode) is accepted: both modes run the
    same fp32 kernel, which meets the tighter fp32 contract (1e-5 of the
    peak)."""
    with scope("af.kernel.fused_mel_mfcc"):
        x = as_tensor(x, plan.device)
        n = x.shape[-1]
        if n < plan.n_fft:
            raise ValueError(f"signal too short to frame: n={n} "
                             f"fft_length={plan.n_fft}")
        n_frames = (n - plan.n_fft) // plan.slide + 1
        lead = x.shape[:-1]
        x2 = x.reshape(-1, n).contiguous()
        if x2.device.type == "cpu":
            mel, cc = fused_mel_mfcc_ref(plan, x2)
        else:
            mel, cc = _launch(plan, x2, n_frames)
        return (mel.reshape(lead + mel.shape[-2:]),
                cc.reshape(lead + cc.shape[-2:]))


fused_mel_mfcc.launches = 0
