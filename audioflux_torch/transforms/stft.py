"""STFT / ISTFT — batched, on one device.

Counterpart of ``audioflux_tpu/transforms/stft.py``.  The reference's
per-frame FFT loop (``src/stft_algorithm.c:696-806``) is one
``ops.fft.rfft`` over the framed ``(..., T, fft)`` tile — the CUDA FFT
kernel at pow2 2048..32768 for a CUDA tensor.  ISTFT is weighted
overlap-add with window-energy normalization (``stft_algorithm.c:304-409``)
after one inverse transform (``ops.cuda_fft.fft_inv`` at the same sizes).

Frame-count semantics are bit-exact with the C library:
``(n - fft) // slide + 1`` unpadded, ``n // slide + 1`` padded.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.frame import (cal_data_length, cal_time_length,
                                       frame_signal)
from audioflux_torch.ops.pad import pad_signal
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.types import (PaddingModeType, PaddingPositionType,
                                   WindowType)

__all__ = ["STFT", "StreamingSTFT", "TailCarry", "stft", "istft"]


def _stft_impl(x, window, *, fft_length, slide_length, is_pad, position,
               mode, value1=0.0, value2=0.0):
    if is_pad:
        x = pad_signal(x, fft_length, slide_length,
                       PaddingPositionType(position), PaddingModeType(mode),
                       value1, value2)
    frames = frame_signal(x, fft_length, slide_length)
    spec = afft.rfft(frames * window, dim=-1)
    return spec.transpose(-1, -2)  # (..., fft//2+1, T)


def _istft_impl(D, window, *, fft_length, slide_length, method_type):
    # D: (..., fft//2+1, T) complex -> (..., (T-1)*slide + fft) real
    return _istft_tm(D.transpose(-1, -2), window, fft_length=fft_length,
                     slide_length=slide_length, method_type=method_type)


def _istft_tm(spec, window, *, fft_length, slide_length, method_type):
    """ISTFT from a time-major (..., T, fft//2+1) spectrum."""
    frames = afft.irfft(spec, n=fft_length, dim=-1)  # (..., T, fft)
    return _ola_frames(frames, window, fft_length=fft_length,
                       slide_length=slide_length, method_type=method_type)


def _istft_tm_pair(spec_a, spec_b, window, *, fft_length, slide_length,
                   method_type):
    """Two ISTFTs for the price of one full complex inverse transform.

    For real outputs a = istft(A) and b = istft(B), linearity gives
    ifft(Afull + i*Bfull) = a_frames + i*b_frames, where Xfull is the
    hermitian extension of the half spectrum X: bins 0..n/2 are A + iB and
    bin n-j (j = 1..n/2-1) is conj(A[j] - i*B[j]).  The overlap-add runs
    once on the complex frames (it is real-linear) and the pair comes back
    as (Re, Im).
    """
    # irfft drops the imaginary parts of the DC and Nyquist bins; force
    # them real so the packed form matches _istft_tm on arbitrary (even
    # hermitian-inconsistent) input
    def real_edges(s):
        s = s.clone()
        s[..., 0] = s[..., 0].real
        s[..., -1] = s[..., -1].real
        return s

    spec_a, spec_b = real_edges(spec_a), real_edges(spec_b)
    zl = spec_a + 1j * spec_b                           # bins 0..n/2
    zh = (spec_a - 1j * spec_b).conj()[..., 1:fft_length // 2]
    zfull = torch.cat([zl, zh.flip(-1)], dim=-1).resolve_conj()
    frames = afft.ifft(zfull, dim=-1)                   # a_frames + i*b_frames
    y = _ola_frames(frames, window, fft_length=fft_length,
                    slide_length=slide_length, method_type=method_type)
    return y.real, y.imag


def _overlap_add(chunks, T, k, slide_length):
    """Frames cut into k chunks of (at most) ``slide_length`` samples,
    (..., T, <=slide) each: chunk j of frame t lands in output block
    t + j, so the overlap-add is k shifted in-place adds of whole slabs —
    deterministic, no scatter.  Returns (..., (T + k - 1) * slide)."""
    first = chunks[0]
    y = first.new_zeros(first.shape[:-2] + (T + k - 1, slide_length))
    for j, ch in enumerate(chunks):
        y[..., j:j + T, :ch.shape[-1]] += ch
    return y.reshape(first.shape[:-2] + (-1,))


def _ola_frames(frames, window, *, fft_length, slide_length, method_type):
    """Window + overlap-add + window-energy normalization of (..., T, fft)
    frames.  Real-linear: works identically on complex frames (used by
    ``_istft_tm_pair`` and HPSS to resynthesize two signals at once).
    ``method_type`` 0 = weighted overlap-add (window on the frames, window^2
    in the norm), 1 = plain overlap-add (window^0 and window^1)."""
    e = 1.0 if method_type == 0 else 0.0
    win1 = window.pow(e)
    win2 = window.pow(e + 1.0)

    T = frames.shape[-2]
    out_len = cal_data_length(T, fft_length, slide_length)
    k = -(-fft_length // slide_length)

    def ola(fr):
        return _overlap_add(fr.split(slide_length, dim=-1), T, k,
                            slide_length)[..., :out_len]

    y = ola(frames * win1)
    norm = ola(win2.expand(T, fft_length))
    norm = torch.where(norm < 1e-6, torch.ones_like(norm), norm)
    return y / norm


def _window_tensor(window, window_type, fft_length, device):
    if window is None:
        window = get_fft_window(window_type, fft_length)
    return as_tensor(window, device)


def stft(x, fft_length: int, slide_length: int,
         window_type: WindowType = WindowType.RECT,
         is_pad: bool = False,
         position: PaddingPositionType = PaddingPositionType.CENTER,
         mode: PaddingModeType = PaddingModeType.CONSTANT,
         value1: float = 0.0, value2: float = 0.0,
         window=None, device=None):
    """Functional STFT. Returns complex64 (..., fft_length//2+1, time)."""
    dev = resolve_device(device)
    return _stft_impl(as_tensor(x, dev),
                      _window_tensor(window, window_type, fft_length, dev),
                      fft_length=fft_length, slide_length=slide_length,
                      is_pad=is_pad, position=int(position), mode=int(mode),
                      value1=value1, value2=value2)


def _as_complex(D, device):
    if isinstance(D, torch.Tensor):
        if D.device.type != device.type:
            raise ValueError(f"tensor on {D.device}, plan on {device}")
        return D.to(device=device, dtype=torch.complex64)
    return torch.from_numpy(np.array(D, dtype=np.complex64)).to(device)


def istft(D, fft_length: int, slide_length: int,
          window_type: WindowType = WindowType.RECT, method_type: int = 0,
          window=None, device=None):
    """Functional ISTFT (weighted overlap-add by default)."""
    dev = resolve_device(device)
    return _istft_impl(_as_complex(D, dev),
                       _window_tensor(window, window_type, fft_length, dev),
                       fft_length=fft_length, slide_length=slide_length,
                       method_type=method_type)


class STFT:
    """Short-time Fourier transform plan.

    Parameters mirror the reference Python API (``python/audioflux/stft.py``):
    ``radix2_exp`` sets ``fft_length = 2**radix2_exp``; default window RECT,
    default slide 1024.  ``device=None`` means ``cuda``.
    """

    def __init__(self, radix2_exp: int = 12,
                 window_type: WindowType = WindowType.RECT,
                 slide_length: int = 1024, is_continue: bool = False,
                 device=None):
        if not 1 <= radix2_exp <= 30:
            raise ValueError("radix2_exp must be in [1, 30]")
        self.device = resolve_device(device)
        self.radix2_exp = radix2_exp
        self.fft_length = 1 << radix2_exp
        self.window_type = WindowType(window_type)
        self.slide_length = slide_length if slide_length else self.fft_length // 4

        self.window = get_fft_window(self.window_type, self.fft_length)
        self._build_exec()
        self.is_pad = False
        self.position = PaddingPositionType.CENTER
        self.mode = PaddingModeType.CONSTANT
        self.value1 = 0.0
        self.value2 = 0.0
        # the C stftObj_new isContinue param (stft_algorithm.c:84); the
        # reference Python wrapper pins it False, this exposes it
        self.set_continue(is_continue)

    # -- config ------------------------------------------------------------
    def set_continue(self, flag: bool):
        """Toggle cross-call tail carry (stftObj_setContinue, :182);
        enabling resets any pending tail."""
        self.is_continue = bool(flag)
        self._carry = (TailCarry(self.fft_length, self.slide_length)
                       if self.is_continue else None)

    def set_slide_length(self, slide_length: int):
        if slide_length > 0:
            self.slide_length = slide_length
            if self._carry is not None:
                self._carry = TailCarry(self.fft_length, self.slide_length)

    def enable_padding(self, flag: bool):
        self.is_pad = bool(flag)

    def set_padding(self, position_type=None, mode_type=None,
                    value1=None, value2=None):
        if not self.is_pad:
            return
        if position_type is not None:
            self.position = PaddingPositionType(position_type)
        if mode_type is not None:
            self.mode = PaddingModeType(mode_type)
        if value1 is not None:
            self.value1 = float(value1)
        if value2 is not None:
            self.value2 = float(value2)

    def _build_exec(self):
        """Upload the window to the plan's device."""
        self._window_t = as_tensor(self.window, self.device)

    def use_window_data_arr(self, data_arr):
        data_arr = np.asarray(data_arr, dtype=np.float32)
        if data_arr.shape[-1] != self.fft_length:
            raise ValueError(f"window length must be {self.fft_length}")
        self.window = data_arr
        self._build_exec()

    def get_window_data_arr(self) -> np.ndarray:
        return self.window

    # -- shape math ---------------------------------------------------------
    def cal_time_length(self, data_length: int) -> int:
        if self._carry is not None and not self.is_pad:
            return self._carry.cal_time_length(data_length)
        return cal_time_length(data_length, self.fft_length, self.slide_length,
                               self.is_pad)

    def cal_data_length(self, time_length: int) -> int:
        return cal_data_length(time_length, self.fft_length, self.slide_length)

    # -- exec ----------------------------------------------------------------
    def stft(self, data_arr) -> torch.Tensor:
        """Compute the STFT. data_arr: (..., n) -> complex64 (..., fre, time).

        With ``is_continue`` set (and padding off), consecutive calls
        carry the unconsumed tail exactly like the C stftObj.
        """
        x = as_tensor(data_arr, self.device)
        if self._carry is not None and not self.is_pad:
            lead = x.shape[:-1]
            x = self._carry.feed(x)
            if x is None:
                return torch.zeros(lead + (self.fft_length // 2 + 1, 0),
                                   dtype=torch.complex64, device=self.device)
        return _stft_impl(x, self._window_t, fft_length=self.fft_length,
                          slide_length=self.slide_length, is_pad=self.is_pad,
                          position=int(self.position), mode=int(self.mode),
                          value1=self.value1, value2=self.value2)

    def istft(self, m_data_arr, method_type: int = 0) -> torch.Tensor:
        """Inverse STFT. m_data_arr: complex (..., fre, time) -> (..., n)."""
        return _istft_impl(_as_complex(m_data_arr, self.device),
                           self._window_t, fft_length=self.fft_length,
                           slide_length=self.slide_length,
                           method_type=method_type)

    # -- coords (API parity) --------------------------------------------------
    def y_coords(self, samplate: int = 32000):
        return np.linspace(0, samplate / 2, self.fft_length // 2 + 1)

    def x_coords(self, data_length: int, samplate: int = 32000):
        T = self.cal_time_length(data_length)
        return np.arange(T) * self.slide_length / samplate


class TailCarry:
    """The stftObj ``isContinue`` cross-call tail state
    (stft_algorithm.c:474-600, non-pad path).

    Each :meth:`feed` consumes ``tail + chunk``; when at least one frame
    fits it returns the sample buffer covering the completed frames and
    carries ``(total - fft) % slide + (fft - slide)`` samples forward;
    otherwise it accumulates the chunk and returns ``None``.  When
    ``slide > fft`` the carry is NEGATIVE — that many samples of the next
    chunk are skipped, exactly as the C's ``tailDataLength < 0`` branch.

    Works on ``(..., n)`` tensors on any device (the C streams 1-D; leading
    dims must stay consistent across calls).
    """

    def __init__(self, fft_length: int, slide_length: int):
        self.fft_length = int(fft_length)
        self.slide_length = int(slide_length)
        self.reset()

    def reset(self):
        self.tail = None
        self.tail_len = 0

    def cal_time_length(self, data_length: int) -> int:
        """Frames the next feed of ``data_length`` samples would emit
        (stftObj_calTimeLength adds the pending tail, :243)."""
        total = self.tail_len + int(data_length)
        if total < self.fft_length:
            return 0
        return (total - self.fft_length) // self.slide_length + 1

    def feed(self, x: torch.Tensor):
        fft, slide = self.fft_length, self.slide_length
        if self.tail_len < 0:
            buf = x[..., -self.tail_len:]
        elif self.tail_len:
            buf = torch.cat([self.tail, x], dim=-1)
        else:
            buf = x
        total = self.tail_len + x.shape[-1]
        if total < fft:
            self.tail = buf.clone()
            self.tail_len = total
            return None
        tail_len = (total - fft) % slide + (fft - slide)
        self.tail = buf[..., total - tail_len:total].clone() if tail_len > 0 else None
        self.tail_len = tail_len
        # the FULL tail+chunk buffer, like the C's curDataArr/validDataArr
        return buf


class StreamingSTFT:
    """Chunked STFT with tail-carry, matching the reference ``isContinue``
    semantics (stft_algorithm.c:474-600): each call consumes
    ``tail + chunk``, emits the frames that fit, and carries the last
    ``(n - fft) % slide + (fft - slide)`` samples into the next call.
    """

    def __init__(self, radix2_exp: int = 12,
                 window_type: WindowType = WindowType.RECT,
                 slide_length: int = 1024, device=None):
        self._stft = STFT(radix2_exp, window_type, slide_length,
                          device=device)
        self.device = self._stft.device
        self.fft_length = self._stft.fft_length
        self.slide_length = self._stft.slide_length
        self._carry = TailCarry(self.fft_length, self.slide_length)

    @property
    def _tail(self):  # kept for callers poking the halo state
        return self._carry.tail

    def reset(self):
        self._carry.reset()

    def process(self, chunk) -> torch.Tensor:
        """Feed a chunk; returns the complex (fre, frames) for the frames
        completed by this chunk (possibly 0 columns)."""
        buf = self._carry.feed(as_tensor(chunk, self.device))
        if buf is None:
            return torch.zeros((self.fft_length // 2 + 1, 0),
                               dtype=torch.complex64, device=self.device)
        return self._stft.stft(buf)
