"""Constant-Q / Variable-Q transform.

Counterpart of ``audioflux_tpu/transforms/cqt.py`` (reference
``src/cqt_algorithm.c`` + ``src/filterbank/cqt_filterBank.c``):
frequency-domain CQT kernels (windowed complex exponentials, transformed,
thresholded; cqt_filterBank.c:246-340) applied to a rect-window padded
STFT per octave; lower octaves reuse the top octave's kernel on a
x2-downsampled signal (cqt_algorithm.c:993-1000, the Brown-Puckette
recursive scheme) through the FAST Kaiser-sinc resampler.

A CUDA float32 call of a plan with ``fft_length`` 512
(``ops.cuda_cqt.supports``: the default 84-bin CQT, ``SimpleCQT``,
``VQT`` at 12 bins an octave, at slides the kernel's shared memory holds)
runs the resampling chain, then takes all octaves in one kernel
(``ops.cuda_cqt.cqt_octaves``: the padding, the frames, the 512-point real
transform, the product with the octave's kernel over each row's run of
nonzero bins, the scale and the final layout).  Every other call takes the
kernel's plain version (``ops.cuda_cqt.cqt_octaves_ref``), from the top
octave down with the chain's next level made after each: each octave as
one padded-frame ``ops.fft.rfft`` in natural bin order (the FFT kernel for
a CUDA tensor at pow2 2048 <= n <= 32768: plans whose top octave needs an
FFT of 2048 or more) and one complex product with the kernel matrix as
four fp32 matrix products.  VQT (beta > 0) uses per-octave kernels.

Postprocessing: chroma fold (chroma_cqtFilterBank), CQCC (log/cbrt+DCT),
CQHC (harmonic picks of the band cepstrum), deconv (cqt_algorithm.h:41-58).
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.dsp.resample import Resample
from audioflux_torch.features.deconv import Deconv, _ceil_pow2
from audioflux_torch.observe import scope, setup_plan
from audioflux_torch.ops import cuda_cqt
from audioflux_torch.ops import fft as afft
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.ops.window import get_fft_window
from audioflux_torch.transforms.spectrogram import (chroma_normalize,
                                                    dct_matrix,
                                                    xxcc_from_spec)
from audioflux_torch.transforms.stft import TailCarry, _as_complex
from audioflux_torch.types import (CepstralRectifyType, ChromaDataNormalType,
                                   ResampleQualityType, SpectralDataType,
                                   SpectralFilterBankNormalType, WindowType)
from audioflux_torch.utils.convert import note_to_hz

__all__ = ["CQT", "VQT", "SimpleCQT", "CQTBase", "cqt_fre_arr",
           "cqt_filter_bank", "chroma_cqt_filter_bank"]


def cqt_fre_arr(min_fre: float, num: int, bin_per_octave: int) -> np.ndarray:
    """Geometric band frequencies (cqt_filterBank.c:cqt_calFreArr)."""
    octave_num = num // bin_per_octave
    arr = np.zeros(num, np.float64)
    v = 2.0 ** (1.0 / bin_per_octave)
    for i in range(octave_num):
        f = np.float32(min_fre * (1 << i))
        arr[i * bin_per_octave] = f
        for j in range(1, bin_per_octave):
            f = np.float32(f * np.float32(v))
            arr[i * bin_per_octave + j] = f
    return arr.astype(np.float32)


def _len_arr(fre, samplate, bin_per_octave, factor, beta):
    v = 2.0 ** (1.0 / bin_per_octave) - 1.0
    q = factor / v
    return (q * samplate / (np.asarray(fre, np.float64) + beta / v)
            ).astype(np.float32)


def cqt_filter_bank(fre, samplate, bin_per_octave, normal_type, window_type,
                    factor, beta, thresh, len_arr, fft_length,
                    fre_global=None, offset=0):
    """Frequency-domain CQT kernels for the given band frequencies.

    Mirrors __cqt_calTempArr + the FFT/threshold pass
    (cqt_filterBank.c:246-389).  Returns complex64 (len(fre), fft//2+1).
    """
    if WindowType(window_type) == WindowType.RECT:
        window_type = WindowType.HANN
    norm = SpectralFilterBankNormalType(normal_type)
    num = len(fre)
    m = fft_length // 2 + 1
    out = np.zeros((num, fft_length), np.complex128)
    for i in range(num):
        flen = float(len_arr[i])
        L = int(np.ceil(flen))
        w = get_fft_window(window_type, L, dtype=np.float64)
        n = np.arange(L, dtype=np.float64)
        phase = 2 * np.pi * n * float(fre[i]) / samplate
        k = (np.cos(phase) + 1j * np.sin(phase)) * w
        if norm == SpectralFilterBankNormalType.NONE:
            k = k / flen
        elif norm == SpectralFilterBankNormalType.AREA:
            k = k / np.abs(k).sum()
        elif norm == SpectralFilterBankNormalType.BAND_WIDTH:
            fg = fre if fre_global is None else fre_global
            j = offset + i
            # the C reads neighbours in the global band array without
            # bounds checks (cqt_filterBank.c:319-321); that array is
            # allocated num+2 long with zeros past [num-1], so the top
            # band's "next" frequency is 0 and its weight negative.  j == 0
            # (a one-octave bank) would read before the buffer in the C;
            # 0 is used there instead.
            lo = fg[j - 1] if j >= 1 else 0.0
            hi = fg[j + 1] if j + 1 < len(fg) else 0.0
            k = k / ((hi - lo) / 2.0)
        k = k * (flen / fft_length)
        start = (fft_length - L) // 2
        out[i, start:start + L] = k
    K = np.fft.fft(out, axis=-1)
    Km = K[:, :m]
    mask = (np.abs(Km) ** 2) > thresh * thresh
    return np.where(mask, Km, 0.0).astype(np.complex64)


def chroma_cqt_filter_bank(num, cqt_length, bin_per_octave,
                           min_fre=32.703196) -> np.ndarray:
    """Octave-fold matrix with tonic rotation
    (chroma_filterBank.c:chroma_cqtFilterBank)."""
    if num > bin_per_octave or bin_per_octave % num != 0:
        raise ValueError("num and bin_per_octave not compatible")
    n = bin_per_octave // num
    offset = int(np.ceil(n / 2.0))
    sub = n - offset
    midi_index = int(np.round(12 * np.log2(min_fre / 440.0) + 69)) % 12
    if midi_index > 6:
        midi_index = 12 - midi_index

    arr = np.zeros((num, cqt_length), np.float32)
    mod = np.arange(cqt_length) % bin_per_octave
    for i in range(num):
        if i != 0:
            start = offset + (i - 1) * n
            arr[i, (mod >= start) & (mod < start + n)] = 1.0
        else:
            arr[i, mod < offset] = 1.0
            if sub:
                arr[i, (mod >= bin_per_octave - sub)] = 1.0
    shift = midi_index * (num // bin_per_octave)
    if shift:
        # rotate rows so that the tonic lands on bin 0
        # (chroma_filterBank.c: output row k <- arr row (shift+k) mod num)
        arr = np.roll(arr, -shift, axis=0)
    return arr


class CQTBase:
    """Shared CQT/VQT machinery (``python/audioflux/cqt.py:107-389`` API
    surface), plus ``device`` (``None`` means ``cuda``)."""

    @setup_plan
    def __init__(self, num=84, samplate=32000, low_fre=None,
                 bin_per_octave=12, factor=1.0, beta=0.0, thresh=0.01,
                 window_type=WindowType.HANN, slide_length=None,
                 is_continue=False,
                 normal_type=SpectralFilterBankNormalType.AREA,
                 is_scale=True, _v_flag=False, device=None):
        if low_fre is None:
            low_fre = note_to_hz("C1")
        if bin_per_octave not in (12, 24, 36):
            raise ValueError("bin_per_octave must be 12, 24 or 36")
        if num % bin_per_octave != 0:
            raise ValueError("num must be a multiple of bin_per_octave")
        self.device = resolve_device(device)

        self.num = num
        self.samplate = samplate
        self.low_fre = float(low_fre)
        self.bin_per_octave = bin_per_octave
        self.factor = float(factor)
        self.beta = float(beta)
        self.thresh = float(thresh)
        self.window_type = WindowType(window_type)
        self.normal_type = SpectralFilterBankNormalType(normal_type)
        self.is_scale = bool(is_scale)
        self._v_flag = bool(_v_flag)

        self.octave_num = num // bin_per_octave
        self.fre_band_arr = cqt_fre_arr(self.low_fre, num, bin_per_octave)

        top = (self.octave_num - 1) * bin_per_octave
        v = 2.0 ** (1.0 / bin_per_octave) - 1.0
        q = self.factor / v
        top_len = int(np.ceil(q * samplate
                              / (self.fre_band_arr[top] + self.beta / v)))
        self.fft_length = _ceil_pow2(top_len)
        self.slide_length = (slide_length if slide_length
                             else self.fft_length // 4)

        s_len = _len_arr(self.fre_band_arr, samplate, bin_per_octave,
                         self.factor, self.beta)
        self._s_len = np.sqrt(s_len.astype(np.float64)).astype(np.float32)
        self._d_len = np.sqrt(np.power(2.0, np.arange(self.octave_num))
                              ).astype(np.float32)

        # One kernel for every octave: at octave k's halved rate the phase
        # f/sr and the window length both equal the top octave's, so the
        # reference's per-octave kernels equal the top octave's
        # (cqt_filterBank.c:95-125).  Except for beta > 0: the C then takes
        # its VQT path (cqt_algorithm.c:188-193, 1238-1245), whose
        # BAND_WIDTH weight reads each octave's own unscaled neighbour
        # frequencies, so the kernels are built per octave.
        top_fre = self.fre_band_arr[top:]
        top_lens = _len_arr(top_fre, samplate, bin_per_octave,
                            self.factor, self.beta)
        if self.beta > 0:
            srs = samplate
            kernels = [None] * self.octave_num
            for i in range(self.octave_num - 1, -1, -1):
                kernels[i] = cqt_filter_bank(
                    self.fre_band_arr[i * bin_per_octave:
                                      (i + 1) * bin_per_octave],
                    srs, bin_per_octave, self.normal_type,
                    self.window_type, self.factor, self.beta, self.thresh,
                    top_lens, self.fft_length,
                    fre_global=self.fre_band_arr, offset=i * bin_per_octave)
                srs //= 2
            self._kernels = kernels
        else:
            self._kernels = [cqt_filter_bank(
                top_fre, samplate, bin_per_octave, self.normal_type,
                self.window_type, self.factor, self.beta, self.thresh,
                top_lens, self.fft_length,
                fre_global=self.fre_band_arr, offset=top)] * self.octave_num

        # cross-call tail carry (cqtObj isContinue: one carry at the top of
        # the multirate chain, right-padded framing; the chain itself is
        # stateless per call, cqt_algorithm.c:346-430, 1303-1320)
        self.is_continue = bool(is_continue)
        self._carry = (TailCarry(self.fft_length, self.slide_length)
                       if self.is_continue else None)

        self._resampler = Resample(ResampleQualityType.FAST, is_scale=True,
                                   device=self.device)
        self._resampler.set_samplate(2, 1)
        self._dct = dct_matrix(num)
        self._deconv = Deconv(num, device=self.device)
        self._scale = self._scale_vec()
        self._build_exec()

    def _build_exec(self):
        """Upload the kernels (``cuda_cqt.octave_kernels``), the scale
        vector and the DCT to the plan's device."""
        dev = self.device
        self._kernels_t = cuda_cqt.octave_kernels(self._kernels, dev)
        self._scale_t = as_tensor(self._scale, dev)
        self._dct_t = as_tensor(self._dct, dev)
        self._chroma_t = {}

    # ------------------------------------------------------------------
    def get_fft_length(self) -> int:
        return self.fft_length

    def get_fre_band_arr(self):
        return self.fre_band_arr

    def cal_time_length(self, data_length: int) -> int:
        if self._carry is not None:
            return self._carry.cal_time_length(data_length)
        return data_length // self.slide_length + 1

    def set_scale(self, flag: bool):
        self.is_scale = bool(flag)
        self._scale = self._scale_vec()
        self._build_exec()

    # ------------------------------------------------------------------
    def _octave_slides(self) -> list:
        """Each octave's slide, lowest octave first."""
        return [self.slide_length >> (self.octave_num - 1 - i)
                for i in range(self.octave_num)]

    def _levels(self, x):
        """``x``, then each lower octave's level of the resample chain, made
        as it is asked for."""
        yield x
        for _ in range(self.octave_num - 1):
            x = self._resampler.resample(x)
            yield x

    def _octaves(self, x, T: int, t0: int = 0):
        """Every octave's frames [t0, t0 + T) -> complex64 (..., num, T):
        where ``cuda_cqt.supports`` the call, the whole resample chain and
        then one kernel; else the plain version, each octave done before
        the chain makes the next level.  Continue mode pads RIGHT instead
        of CENTER, like the C cqtObj's internal stft
        (cqt_algorithm.c:1303-1320)."""
        slides = self._octave_slides()
        kw = dict(fft_length=self.fft_length, T=T, t0=t0,
                  center=not self.is_continue)
        if cuda_cqt.supports(x, self.fft_length, slides, T):
            return cuda_cqt.cqt_octaves(list(self._levels(x))[::-1], slides,
                                        self._kernels_t, self._scale_t, **kw)
        return cuda_cqt.cqt_octaves_ref(self._levels(x), slides,
                                        self._kernels_t, self._scale_t, **kw)

    def _scale_vec(self) -> np.ndarray:
        """Per-bin output scaling: each octave's sqrt(2^d) downsampling
        compensation, divided per bin by sqrt(len_arr) when is_scale."""
        bpo = self.bin_per_octave
        v = np.zeros(self.num, np.float32)
        for i in range(self.octave_num):
            scale = self._d_len[self.octave_num - i - 1]
            sl = slice(i * bpo, (i + 1) * bpo)
            v[sl] = scale / self._s_len[sl] if self.is_scale else scale
        return v

    def cqt(self, data_arr):
        """(..., n) -> complex64 (..., num, time).

        With ``is_continue`` set, consecutive calls carry the unconsumed
        sample tail (cqtObj isContinue); each call emits the frames that
        the accumulated samples complete."""
        with scope(f"af.{type(self).__name__}.cqt"):
            x = as_tensor(data_arr, self.device)
            if self._carry is not None:
                buf = self._carry.feed(x)
                if buf is None:
                    return torch.zeros(x.shape[:-1] + (self.num, 0),
                                       dtype=torch.complex64,
                                       device=self.device)
                x = buf
                # the carried buffer: (len - fft) // slide + 1 frames
                T = (x.shape[-1] - self.fft_length) // self.slide_length + 1
            else:
                T = x.shape[-1] // self.slide_length + 1
            return self._octaves(x, T)

    def _cqt_frames(self, x, t0: int, t1: int):
        """Output frames [t0, t1) of :meth:`cqt` (not in continue mode):
        (..., num, t1 - t0).  The resample chain runs over the whole
        signal; each octave frames and transforms only those frames (the
        body of the frame-sharded ``parallel.sharded_cqt_fn``)."""
        if self.is_continue:
            raise ValueError("frame ranges need is_continue=False")
        return self._octaves(x, t1 - t0, t0)

    # -- postprocessing ------------------------------------------------------
    def chroma(self, m_cqt_data, chroma_num: int = 12,
               data_type: SpectralDataType = SpectralDataType.POWER,
               norm_type: ChromaDataNormalType = ChromaDataNormalType.MAX):
        """Fold the complex CQT into chroma (cqt_algorithm.c:cqtObj_chroma)."""
        with scope(f"af.{type(self).__name__}.chroma"):
            cfb = self._chroma_t.get(chroma_num)
            if cfb is None:
                cfb = self._chroma_t[chroma_num] = as_tensor(
                    chroma_cqt_filter_bank(chroma_num, self.num,
                                           self.bin_per_octave, self.low_fre),
                    self.device)
            D = _as_complex(m_cqt_data, self.device).transpose(-1, -2)
            P = D.real.square() + D.imag.square()
            if SpectralDataType(data_type) == SpectralDataType.MAG:
                P = P.sqrt()
            out = chroma_normalize(torch.matmul(P, cfb.T),
                                   ChromaDataNormalType(norm_type))
            return out.transpose(-1, -2).contiguous()

    def cqcc(self, m_data_arr, cc_num: int = 13,
             rectify_type: CepstralRectifyType = CepstralRectifyType.LOG):
        """Cepstral coefficients of the (mag) CQT spectrogram."""
        return xxcc_from_spec(m_data_arr, self._dct_t, cc_num,
                              CepstralRectifyType(rectify_type))

    def cqhc(self, m_data_arr, hc_num: int = 13):
        """Harmonic coefficients: the band cepstrum sampled at harmonic
        quefrencies round(bpo*log2(j+1)) (cqt_algorithm.c:cqtObj_cqhc)."""
        L = _ceil_pow2(2 * self.num)
        x = as_tensor(m_data_arr, self.device).transpose(-1, -2)
        ceps = afft.ifft(afft.fft(x, n=L, dim=-1).abs(), dim=-1).real
        idx = np.round(self.bin_per_octave
                       * np.log2(np.arange(1, hc_num + 1))).astype(np.int64)
        out = ceps[..., torch.from_numpy(idx).to(self.device)]
        return out.transpose(-1, -2).contiguous()

    def deconv(self, m_data_arr):
        """(timbre, pitch) of the mag CQT (cqt_algorithm.c:cqtObj_deconv)."""
        return self._deconv.deconv(m_data_arr)

    def y_coords(self):
        return self.fre_band_arr

    def x_coords(self, data_length: int):
        T = self.cal_time_length(data_length)
        return np.arange(T) * self.slide_length / self.samplate


class CQT(CQTBase):
    def __init__(self, num=84, samplate=32000, low_fre=None,
                 bin_per_octave=12, factor=1.0, beta=0.0, thresh=0.01,
                 window_type=WindowType.HANN, slide_length=None,
                 is_continue=False,
                 normal_type=SpectralFilterBankNormalType.AREA,
                 is_scale=True, device=None):
        # the reference CQT ctor (cqt.py:21-24) takes beta too; beta > 0
        # gives the variable-Q bank exactly as VQT does
        super().__init__(num=num, samplate=samplate, low_fre=low_fre,
                         bin_per_octave=bin_per_octave, factor=factor,
                         beta=beta, thresh=thresh, window_type=window_type,
                         slide_length=slide_length, is_continue=is_continue,
                         normal_type=normal_type,
                         is_scale=is_scale, _v_flag=beta > 0, device=device)


class VQT(CQTBase):
    """Variable-Q transform: beta > 0 flattens low-frequency bandwidths."""

    def __init__(self, num=84, samplate=32000, low_fre=None,
                 bin_per_octave=12, factor=1.0, beta=0.5, thresh=0.01,
                 window_type=WindowType.HANN, slide_length=None,
                 is_continue=False,
                 normal_type=SpectralFilterBankNormalType.AREA,
                 is_scale=True, device=None):
        super().__init__(num=num, samplate=samplate, low_fre=low_fre,
                         bin_per_octave=bin_per_octave, factor=factor,
                         beta=beta, thresh=thresh, window_type=window_type,
                         slide_length=slide_length, is_continue=is_continue,
                         normal_type=normal_type,
                         is_scale=is_scale, _v_flag=True, device=device)


class SimpleCQT(CQTBase):
    """Preset CQT matching the reference's simple ctor (cqtObj_new)."""

    def __init__(self, num=84, samplate=32000, low_fre=None, device=None):
        super().__init__(num=num, samplate=samplate, low_fre=low_fre,
                         normal_type=SpectralFilterBankNormalType.NONE,
                         is_scale=True, _v_flag=False, device=device)
