"""Filterbank spectrogram hub (the reference's ``spectrogram_algorithm.c``).

Pipeline:

    frame -> window -> rfft -> power/mag -> filterbank matmul
          -> [chroma normalize | double-matmul log-chroma] -> (num, time)

plus the cepstral family (MFCC/BFCC/GTCC/LFCC/xxcc) as log/cbrt -> DCT-II
(ortho) matmuls, and the fused throughput path ``spectrogram_mfcc_fused``
(CUDA kernel ``ops.fused_mel``).  Covers scales LINEAR/LINSPACE/MEL/BARK/
ERB/OCTAVE/LOG/CHROMA/LOG_CHROMA.

Counterpart of ``audioflux_tpu/transforms/spectrogram.py``.  Plans hold
their constants as tensors on one device (``device=None`` -> ``cuda``,
which must exist; tests pass ``device="cpu"``).  Matrix products run in
full fp32 (``torch.backends.cuda.matmul.allow_tf32`` stays False), the
counterpart of the TPU package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.filterbank import scales as _sc
from audioflux_torch.filterbank.auditory import auditory_filter_bank
from audioflux_torch.filterbank.chroma import (chroma_fold_filter_bank,
                                               chroma_stft_filter_bank)
from audioflux_torch.observe import scope
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.frame import cal_time_length, frame_signal
from audioflux_torch.ops.fused_mel import FusedMelPlan, fused_mel_mfcc
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.types import (
    CepstralRectifyType,
    ChromaDataNormalType,
    SpectralDataType,
    SpectralFilterBankNormalType,
    SpectralFilterBankScaleType,
    SpectralFilterBankStyleType,
    WindowType,
)
from audioflux_torch.utils.convert import note_to_hz

__all__ = [
    "Spectrogram", "MelSpectrogram", "BarkSpectrogram", "ErbSpectrogram",
    "chroma_normalize", "dct_matrix", "xxcc_from_spec",
]


def _power_spec(frames, window, fft_length):
    spec = afft.rfft(frames * window, n=fft_length, dim=-1)
    return spec.real.square() + spec.imag.square()


def dct_matrix(n: int, dtype=np.float32) -> np.ndarray:
    """Orthonormal DCT-II matrix (row k applied to length-n frames).

    Matches ``fftObj_dct(..., isNorm=1)`` (fft_algorithm.c:139-140,666-669):
    scale sqrt(1/n) for k=0, sqrt(2/n) otherwise.
    """
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    m[0] *= np.sqrt(1.0 / n)
    m[1:] *= np.sqrt(2.0 / n)
    return m.astype(dtype)


def chroma_normalize(x: torch.Tensor, norm_type: ChromaDataNormalType):
    """Per-frame normalization over the band axis (last).

    x: (..., T, num). Reference __mnormalize (flux_vector.c) with zero-guard:
    rows whose norm is 0 are left untouched.
    """
    a = x.abs()
    if norm_type == ChromaDataNormalType.MAX:
        v = a.amax(dim=-1, keepdim=True)
    elif norm_type == ChromaDataNormalType.MIN:
        v = a.amin(dim=-1, keepdim=True)
    elif norm_type == ChromaDataNormalType.P2:
        v = a.square().sum(dim=-1, keepdim=True).sqrt()
    elif norm_type == ChromaDataNormalType.P1:
        v = a.sum(dim=-1, keepdim=True)
    else:
        return x
    return torch.where(v != 0, x / v, x)


def xxcc_from_spec(m_data, dct_m: torch.Tensor, cc_num: int,
                   rectify: CepstralRectifyType = CepstralRectifyType.LOG):
    """Cepstral coefficients from a (..., num, T) band spectrogram.

    log10 (floored at 1e-8) or cubic-root rectification, then ortho DCT-II
    over bands; returns (..., cc_num, T). Reference __spectrogramObj_xxcc
    (spectrogram_algorithm.c:1409-1477).  ``m_data`` goes to ``dct_m``'s
    device.
    """
    x = as_tensor(m_data, dct_m.device).transpose(-1, -2)  # (..., T, num)
    if rectify == CepstralRectifyType.CUBIC_ROOT:
        r = torch.sign(x) * x.abs().pow(1.0 / 3.0)
    else:
        r = torch.log10(torch.clamp(x, min=1e-8))
    cc = torch.matmul(r, dct_m[:cc_num].T)
    return cc.transpose(-1, -2).contiguous()


def _forward(name):
    """A ``Spectral`` feature of this plan's bands (the edge subset of
    :meth:`Spectrogram.set_edge` applies)."""
    def fwd(self, m_data_arr, *args, **kwargs):
        return getattr(self._spectral_obj(), name)(m_data_arr, *args,
                                                   **kwargs)
    fwd.__name__ = name
    fwd.__doc__ = (f"``Spectral.{name}`` over this plan's bands (the edge "
                   "subset applies); see ``features.spectral``.")
    return fwd


class Spectrogram:
    """Spectrogram plan: window + filterbank constants on one device.

    Parameter surface mirrors the reference Python class
    (``python/audioflux/spectrogram.py:31-140``), plus ``device``; the
    feature surface of the reference's ``SpectrogramBase``
    (``spectrogram.py:328-1770``: the ``Spectral`` features, ``set_edge``,
    ``preprocess``, ``deconv``) is forwarded over the plan's bands.
    """

    def __init__(self, num=0, samplate=32000, low_fre=None, high_fre=None,
                 bin_per_octave=12, radix2_exp=12, window_type=None,
                 slide_length=None,
                 data_type=SpectralDataType.POWER,
                 filter_bank_type=SpectralFilterBankScaleType.LINEAR,
                 style_type=SpectralFilterBankStyleType.SLANEY,
                 normal_type=SpectralFilterBankNormalType.NONE,
                 is_continue=False, device=None):
        S = SpectralFilterBankScaleType
        scale = SpectralFilterBankScaleType(filter_bank_type)
        style = SpectralFilterBankStyleType(style_type)
        norm = SpectralFilterBankNormalType(normal_type)
        data_type = SpectralDataType(data_type)
        self.device = resolve_device(device)

        if not 1 <= radix2_exp <= 30:
            raise ValueError("radix2_exp must be in [1, 30]")
        fft_length = 1 << radix2_exp

        log_like = scale in (S.OCTAVE, S.LOG, S.LOG_CHROMA, S.DEEP, S.DEEP_CHROMA)
        if low_fre is None:
            low_fre = note_to_hz("C1") if log_like else 0.0
        if high_fre is None:
            high_fre = samplate / 2.0
        if log_like and low_fre < round(note_to_hz("C1"), 3):
            raise ValueError(f"{scale.name} low_fre={low_fre} must be >= 32.703")
        if low_fre < 0:
            raise ValueError("low_fre must be non-negative")

        if window_type is None:
            window_type = (WindowType.HAMM
                           if scale in (S.DEEP, S.DEEP_CHROMA)
                           else WindowType.HANN)
        window_type = WindowType(window_type)

        if slide_length is None:
            slide_length = fft_length // 4

        if bin_per_octave % 12 != 0:
            bin_per_octave = 12

        # --- ctor revision logic (spectrogram_algorithm.c:440-530) ---
        low_index = high_index = 0
        base_num = 0
        if scale in (S.LINEAR, S.CHROMA):
            det = samplate / float(fft_length)
            low_index = int(np.round(np.float32(low_fre) / np.float32(det)))
            high_index = int(np.round(np.float32(high_fre) / np.float32(det)))

        if scale == S.LINEAR:
            num = high_index - low_index + 1
        elif scale == S.OCTAVE:
            # snap to the log grid (isEdge=1): low=log(low), high=low+num-1
            lo = _sc.hz_to_log(low_fre, bin_per_octave)
            low_fre = float(_sc.log_to_hz(lo, bin_per_octave))
            high_fre = float(_sc.log_to_hz(lo + num - 1, bin_per_octave))
            if high_fre > samplate / 2.0:
                raise ValueError("scale log: low_fre and num too large, overflow")
            base_num = num
        elif scale == S.CHROMA:
            if num < 12 or num % 12 != 0:
                num = 12
            base_num = high_index - low_index + 1
        elif scale == S.LOG_CHROMA:
            if num <= 0 or num > bin_per_octave or bin_per_octave % num != 0:
                num = 12
            lo = float(_sc.hz_to_log(low_fre, bin_per_octave))
            hi = float(_sc.hz_to_log(high_fre, bin_per_octave))
            base_num = int(hi - lo) + 1
            low_fre = float(_sc.log_to_hz(lo, bin_per_octave))

        if num < 2 or num > fft_length // 2 + 1:
            raise ValueError(f"num={num} is out of range")

        self.num = num
        self.samplate = samplate
        self.low_fre = low_fre
        self.high_fre = high_fre
        self.bin_per_octave = bin_per_octave
        self.radix2_exp = radix2_exp
        self.fft_length = fft_length
        self.window_type = window_type
        self.slide_length = slide_length
        self.data_type = data_type
        self.filter_bank_type = scale
        self.style_type = style
        self.normal_type = norm
        self.low_index = low_index
        self.high_index = high_index
        self.base_num = base_num
        self.norm_value = 1.0
        self.chroma_data_normal_type = ChromaDataNormalType.MAX
        # cross-call tail carry (SpectrogramBase is_continue, passed to
        # the C stftObj; spectrogram.py:40 + stft_algorithm.c:474-600)
        self.is_continue = bool(is_continue)
        if self.is_continue:
            from audioflux_torch.transforms.stft import TailCarry
            self._carry = TailCarry(fft_length, slide_length)
        else:
            self._carry = None

        self.window = get_fft_window(window_type, fft_length)

        # --- filterbank constants (numpy; uploaded by _build_exec) ---
        self.filter_bank = None
        self.chroma_filter_bank = None
        self.fre_band_arr = None
        self.bin_band_arr = None
        m_len = fft_length // 2 + 1

        if scale in (S.LINSPACE, S.MEL, S.BARK, S.ERB, S.OCTAVE, S.LOG):
            fb, fre, bins = auditory_filter_bank(
                num, fft_length, samplate, scale, style, norm,
                low_fre, high_fre, bin_per_octave)
            self.filter_bank = fb
            self.fre_band_arr = fre
            self.bin_band_arr = bins
        elif scale == S.CHROMA:
            self.filter_bank = chroma_stft_filter_bank(num, fft_length, samplate)
            det = samplate / float(fft_length)
            self.fre_band_arr = (np.arange(low_index, high_index + 1) * det
                                 ).astype(np.float32)
            self.bin_band_arr = np.arange(low_index, high_index + 1,
                                          dtype=np.int32)
        elif scale == S.LOG_CHROMA:
            fb, fre, bins = auditory_filter_bank(
                base_num, fft_length, samplate, S.LOG_CHROMA, style, norm,
                low_fre, high_fre, bin_per_octave)
            self.filter_bank = fb
            self.fre_band_arr = fre
            self.bin_band_arr = bins
            self.chroma_filter_bank = chroma_fold_filter_bank(
                num, base_num, bin_per_octave, low_fre)
        elif scale == S.LINEAR:
            det = samplate / float(fft_length)
            self.fre_band_arr = (np.arange(low_index, high_index + 1) * det
                                 ).astype(np.float32)
            self.bin_band_arr = np.arange(low_index, high_index + 1,
                                          dtype=np.int32)
        else:
            raise NotImplementedError(
                f"scale {scale.name} is provided by the DEEP spectrogram, "
                "which is not ported yet")

        self._mlen = m_len
        self._dct = dct_matrix(self.num)
        self._build_exec()

    # ------------------------------------------------------------------
    def _build_exec(self):
        """Upload the numpy constants to the plan's device and drop the
        fused path's cached plans."""
        dev = self.device
        up = lambda a: None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, np.float32)).to(dev)
        self._window_t = up(self.window)
        self._dct_t = up(self._dct)
        self._cfb_t = up(self.chroma_filter_bank)
        fb = self.filter_bank
        if (fb is not None
                and self.filter_bank_type == SpectralFilterBankScaleType.CHROMA
                and (self.low_index != 0
                     or self.high_index != self.fft_length // 2)):
            # the CHROMA bin range as a 0/1 mask folded into the bank:
            # sum_k P_k mask_k fb_mk, the same terms as masking P
            mask = np.zeros((self._mlen,), np.float32)
            mask[self.low_index:self.high_index + 1] = 1.0
            fb = fb * mask
        self._fb_t = up(fb)
        self._fused_cache = {}

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        S = SpectralFilterBankScaleType
        scale = self.filter_bank_type
        data_type = self.data_type
        fft_length = self.fft_length
        norm_value = self.norm_value
        low_index, high_index = self.low_index, self.high_index

        frames = frame_signal(x, fft_length, self.slide_length)
        S2 = _power_spec(frames, self._window_t, fft_length)  # (..., T, m)

        if scale == S.LINEAR:
            if low_index == 0 and high_index == fft_length // 2:
                out = S2
            else:
                out = S2[..., low_index:high_index + 1]
            if data_type == SpectralDataType.MAG:
                out = out.sqrt()
            if norm_value != 1:
                out = out.pow(norm_value)
            return out.transpose(-1, -2).contiguous()

        Sx = S2.sqrt() if data_type == SpectralDataType.MAG else S2
        if data_type == SpectralDataType.POWER and norm_value != 1:
            Sx = Sx.pow(norm_value)

        out = torch.matmul(Sx, self._fb_t.T)
        if scale == S.LOG_CHROMA:
            out = torch.matmul(out, self._cfb_t.T)
        if data_type == SpectralDataType.MAG and norm_value != 1:
            out = out.pow(norm_value)
        if scale in (S.CHROMA, S.LOG_CHROMA):
            out = chroma_normalize(out, self.chroma_data_normal_type)
        return out.transpose(-1, -2).contiguous()

    # ------------------------------------------------------------------
    def set_data_norm_value(self, norm_value: float):
        self.norm_value = float(norm_value)
        self._build_exec()

    def set_chroma_data_normal_type(self, t: ChromaDataNormalType):
        self.chroma_data_normal_type = ChromaDataNormalType(t)
        self._build_exec()

    def cal_time_length(self, data_length: int) -> int:
        if self._carry is not None:
            return self._carry.cal_time_length(data_length)
        return cal_time_length(data_length, self.fft_length, self.slide_length)

    def get_fre_band_arr(self):
        return self.fre_band_arr

    def get_bin_band_arr(self):
        return self.bin_band_arr

    def get_band_num(self):
        return self.num

    def get_bin_band_length(self):
        """Band count (spectrogramObj_getBinBandLength,
        spectrogram_algorithm.c:3192 returns ->num)."""
        return self.num

    def set_deep_order(self, deep_order: int):
        """Stored for DEEP-scale neighbor-channel layout
        (spectrogramObj_setDeepOrder; a no-op for non-deep scales, as in
        the C).  1/2 -> 3 channels, 3/4 -> 5 channels."""
        if deep_order not in (1, 2, 3, 4):
            raise ValueError(f"deep_order={deep_order} must be in [1,4]")
        self.deep_order = int(deep_order)

    # ------------------------------------------------------------------
    def spectrogram(self, data_arr) -> torch.Tensor:
        """Compute the band spectrogram: (..., n) -> (..., num, time).

        With ``is_continue`` set, consecutive calls carry the unconsumed
        sample tail across calls (streaming), like the C spectrogramObj.
        """
        with scope(f"af.{type(self).__name__}.spectrogram"):
            x = as_tensor(data_arr, self.device)
            if self._carry is not None:
                buf = self._carry.feed(x)
                if buf is None:
                    return torch.zeros(x.shape[:-1] + (self.num, 0),
                                       dtype=torch.float32, device=self.device)
                x = buf
            return self._run(x)

    def spectrogram_mfcc_fused(self, data_arr, cc_num: int = 13,
                               tile: int = 200, fast: bool = True):
        """Fused band spectrogram + cepstral coefficients.

        Every frame count runs the fused CUDA kernel (``ops.fused_mel``):
        framing -> FFT -> power -> filterbank -> log-DCT with only the
        audio and the two outputs in device memory.  Requires a plain
        power-domain filterbank config (POWER data type, no chroma fold,
        norm_value 1), slide dividing fft and 128 | slide.  ``tile`` (the
        TPU kernel's frame tile; the CUDA kernel sizes its own) and
        ``fast`` are accepted for call compatibility with the TPU package:
        both modes run fp32.  Returns ((..., num, T), (..., cc_num, T)).
        """
        with scope(f"af.{type(self).__name__}.spectrogram_mfcc_fused"):
            S = SpectralFilterBankScaleType
            if (self.filter_bank is None
                    or self.filter_bank_type in (S.CHROMA, S.LOG_CHROMA)
                    or self.data_type != SpectralDataType.POWER
                    or self.norm_value != 1):
                raise ValueError("fused path needs a plain POWER filterbank "
                                 "spectrogram; use .spectrogram()")
            plan = self._fused_cache.get(cc_num)
            if plan is None:
                plan = FusedMelPlan(self.window, self.filter_bank,
                                    self._dct[:cc_num], self.slide_length,
                                    device=self.device)
                self._fused_cache[cc_num] = plan
            return fused_mel_mfcc(plan, data_arr, fast=fast)

    def xxcc(self, m_data_arr, cc_num: int = 13,
             rectify_type: CepstralRectifyType = CepstralRectifyType.LOG):
        if cc_num > self.num:
            raise ValueError(f"cc_num={cc_num} must be <= num={self.num}")
        return xxcc_from_spec(m_data_arr, self._dct_t, cc_num,
                              CepstralRectifyType(rectify_type))

    def mfcc(self, m_data_arr, cc_num: int = 13):
        if not (self.filter_bank_type == SpectralFilterBankScaleType.MEL
                and self.style_type == SpectralFilterBankStyleType.SLANEY):
            raise ValueError("mfcc requires MEL scale and SLANEY style")
        return self.xxcc(m_data_arr, cc_num)

    def bfcc(self, m_data_arr, cc_num: int = 13):
        if not (self.filter_bank_type == SpectralFilterBankScaleType.BARK
                and self.style_type == SpectralFilterBankStyleType.SLANEY):
            raise ValueError("bfcc requires BARK scale and SLANEY style")
        return self.xxcc(m_data_arr, cc_num)

    def gtcc(self, m_data_arr, cc_num: int = 13):
        if self.style_type != SpectralFilterBankStyleType.GAMMATONE:
            raise ValueError("gtcc requires GAMMATONE style")
        return self.xxcc(m_data_arr, cc_num)

    def lfcc(self, m_data_arr, cc_num: int = 13):
        if self.filter_bank_type != SpectralFilterBankScaleType.LINEAR:
            raise ValueError("lfcc requires LINEAR scale")
        return self.xxcc(m_data_arr, cc_num)

    # -- the SpectrogramBase feature surface ------------------------------
    flatness = _forward("flatness")
    flux = _forward("flux")
    rolloff = _forward("rolloff")
    centroid = _forward("centroid")
    spread = _forward("spread")
    skewness = _forward("skewness")
    kurtosis = _forward("kurtosis")
    entropy = _forward("entropy")
    crest = _forward("crest")
    slope = _forward("slope")
    decrease = _forward("decrease")
    band_width = _forward("band_width")
    rms = _forward("rms")
    energy = _forward("energy")
    hfc = _forward("hfc")
    sd = _forward("sd")
    sf = _forward("sf")
    mkl = _forward("mkl")
    pd = _forward("pd")
    wpd = _forward("wpd")
    nwpd = _forward("nwpd")
    cd = _forward("cd")
    rcd = _forward("rcd")
    broadband = _forward("broadband")
    novelty = _forward("novelty")
    eef = _forward("eef")
    eer = _forward("eer")
    max = _forward("max")
    mean = _forward("mean")
    var = _forward("var")

    def _spectral_obj(self):
        """The plan's ``Spectral`` feature object, made on first use and
        after each change of the edge subset."""
        from audioflux_torch.features.spectral import Spectral
        if getattr(self, "_spectral_cache", None) is None:
            sp = Spectral(self.num, self.fre_band_arr, device=self.device)
            edge = getattr(self, "_edge", None)
            if edge is not None:
                kind, val = edge
                if kind == "range":
                    sp.set_edge(*val)
                else:
                    sp.set_edge_arr(val)
            self._spectral_cache = sp
        return self._spectral_cache

    def set_edge(self, start: int, end: int):
        """Restrict the forwarded spectral features to bands [start, end]."""
        self._edge = ("range", (start, end))
        self._spectral_cache = None

    def set_edge_arr(self, index_arr):
        """Restrict the forwarded spectral features to the given bands."""
        self._edge = ("arr", np.asarray(index_arr, np.int64))
        self._spectral_cache = None

    def preprocess(self, m_data_arr):
        """COA normalization of a band spectrogram
        (spectrogramObj_preprocess, spectrogram_algorithm.c:2080-2118)."""
        w_sum = float(np.sum(self.window, dtype=np.float64))
        value = 0.5 * w_sum if self.data_type == SpectralDataType.MAG \
            else 0.5 * w_sum * w_sum
        scale = np.ones(self.num, np.float32)
        if self.bin_band_arr is not None:
            bins = np.asarray(self.bin_band_arr)
            edge = (bins == 0) | (bins == self.fft_length // 2)
            scale[edge[:self.num]] = 0.5
        else:
            scale[0] = 0.5
        x = as_tensor(m_data_arr, self.device) / np.float32(value)
        return x * as_tensor(scale, self.device)[:, None]

    def deconv(self, m_data_arr):
        """Timbre/pitch deconvolution of this plan's spectrogram."""
        from audioflux_torch.features.deconv import Deconv
        return Deconv(self.num, device=self.device).deconv(m_data_arr)

    # ------------------------------------------------------------------
    def y_coords(self):
        return self.fre_band_arr

    def x_coords(self, data_length: int):
        T = self.cal_time_length(data_length)
        return np.arange(T) * self.slide_length / self.samplate


class MelSpectrogram(Spectrogram):
    def __init__(self, num=128, samplate=32000, low_fre=None, high_fre=None,
                 radix2_exp=12, window_type=None, slide_length=None,
                 data_type=SpectralDataType.POWER,
                 style_type=SpectralFilterBankStyleType.SLANEY,
                 normal_type=SpectralFilterBankNormalType.NONE,
                 is_continue=False, device=None):
        super().__init__(num=num, samplate=samplate, low_fre=low_fre,
                         high_fre=high_fre, bin_per_octave=12,
                         radix2_exp=radix2_exp, window_type=window_type,
                         slide_length=slide_length, data_type=data_type,
                         filter_bank_type=SpectralFilterBankScaleType.MEL,
                         style_type=style_type, normal_type=normal_type,
                         is_continue=is_continue, device=device)


class BarkSpectrogram(Spectrogram):
    def __init__(self, num=128, samplate=32000, low_fre=None, high_fre=None,
                 radix2_exp=12, window_type=None, slide_length=None,
                 data_type=SpectralDataType.POWER,
                 style_type=SpectralFilterBankStyleType.SLANEY,
                 normal_type=SpectralFilterBankNormalType.NONE,
                 is_continue=False, device=None):
        super().__init__(num=num, samplate=samplate, low_fre=low_fre,
                         high_fre=high_fre, bin_per_octave=12,
                         radix2_exp=radix2_exp, window_type=window_type,
                         slide_length=slide_length, data_type=data_type,
                         filter_bank_type=SpectralFilterBankScaleType.BARK,
                         style_type=style_type, normal_type=normal_type,
                         is_continue=is_continue, device=device)


class ErbSpectrogram(Spectrogram):
    def __init__(self, num=128, samplate=32000, low_fre=None, high_fre=None,
                 radix2_exp=12, window_type=None, slide_length=None,
                 data_type=SpectralDataType.POWER,
                 style_type=SpectralFilterBankStyleType.SLANEY,
                 normal_type=SpectralFilterBankNormalType.NONE,
                 is_continue=False, device=None):
        super().__init__(num=num, samplate=samplate, low_fre=low_fre,
                         high_fre=high_fre, bin_per_octave=12,
                         radix2_exp=radix2_exp, window_type=window_type,
                         slide_length=slide_length, data_type=data_type,
                         filter_bank_type=SpectralFilterBankScaleType.ERB,
                         style_type=style_type, normal_type=normal_type,
                         is_continue=is_continue, device=device)
