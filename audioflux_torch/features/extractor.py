"""Batch feature extraction façade over the transform families.

Counterpart of ``audioflux_tpu/features/extractor.py`` (reference
``python/audioflux/feature/extractor.py:40-446``): build several transform
plans at once, run them over the same audio, then push the resulting
spectrograms through Spectral / XXCC / Deconv.  No state crosses
transforms.

Every plan is built on the extractor's ``device`` (``None`` means
``cuda``), and every result stays a tensor on it: the TPU package moves
each result to the host (``np.asarray``, ``spec_convert=np.abs``); here
``spec_convert`` defaults to ``torch.abs`` and no call leaves the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from audioflux_torch.features.deconv import Deconv
from audioflux_torch.features.spectral import Spectral
from audioflux_torch.features.xxcc import XXCC
from audioflux_torch.ops.backend import as_tensor, resolve_device
from audioflux_torch.transforms.bft import BFT
from audioflux_torch.transforms.cqt import CQT
from audioflux_torch.transforms.cwt import CWT
from audioflux_torch.transforms.dwt import DWT, WPT
from audioflux_torch.transforms.fst import FST
from audioflux_torch.transforms.nsgt import NSGT
from audioflux_torch.transforms.pwt import PWT
from audioflux_torch.transforms.st import ST
from audioflux_torch.types import (CepstralRectifyType, SpectralDataType,
                                   SpectralFilterBankNormalType,
                                   SpectralFilterBankScaleType,
                                   SpectralFilterBankStyleType,
                                   WaveletContinueType, WindowType)

__all__ = ["FeatureExtractor", "FeatureResult"]

_TRANSFORMS = ("bft", "nsgt", "cwt", "pwt", "cqt", "st", "fst", "dwt", "wpt")
# the transforms of one 2**radix2_exp window: the audio is cut or padded
_FIXED_LENGTH = ("cwt", "pwt", "st", "fst", "dwt", "wpt")


class FeatureResult(dict):
    """Per-transform result dict (``feature/extractor.py:18-37``)."""

    def __init__(self, name):
        super().__init__()
        self.name = name

    def __repr__(self):
        return f"FeatureResult({self.name}: {list(self.keys())})"


class FeatureExtractor:
    """API mirrors ``python/audioflux/feature/extractor.py:40-446``, plus
    ``device`` (``None`` means ``cuda``), which every plan it builds
    takes."""

    def __init__(self, transforms, num=None, radix2_exp=12, samplate=32000,
                 low_fre=None, high_fre=None, bin_per_octave=12,
                 slide_length=None,
                 scale_type=SpectralFilterBankScaleType.LINEAR,
                 wavelet_type=WaveletContinueType.MORSE, device=None):
        if isinstance(transforms, str):
            transforms = [transforms]
        for t in transforms:
            if t not in _TRANSFORMS:
                raise ValueError(f"unsupported transform {t!r}; "
                                 f"choose from {_TRANSFORMS}")
        self.device = resolve_device(device)
        self.transforms = list(transforms)
        self.num = num
        self.radix2_exp = radix2_exp
        self.samplate = samplate
        self.low_fre = low_fre
        self.high_fre = high_fre
        self.bin_per_octave = bin_per_octave
        self.slide_length = slide_length
        self.scale_type = SpectralFilterBankScaleType(scale_type)
        self.wavelet_type = WaveletContinueType(wavelet_type)
        self._objs = {name: self._create(name) for name in self.transforms}

    # ------------------------------------------------------------------
    def _create(self, name):
        kw = dict(radix2_exp=self.radix2_exp, samplate=self.samplate,
                  device=self.device)
        band = dict(low_fre=self.low_fre, high_fre=self.high_fre,
                    bin_per_octave=self.bin_per_octave,
                    scale_type=self.scale_type)
        if name == "bft":
            # the reference facade builds its BFT with MAG data
            # (feature/extractor.py:177-185), not POWER
            return BFT(num=self.num or 128, window_type=WindowType.HANN,
                       slide_length=self.slide_length,
                       style_type=SpectralFilterBankStyleType.SLANEY,
                       normal_type=SpectralFilterBankNormalType.NONE,
                       data_type=SpectralDataType.MAG, **band, **kw)
        if name == "nsgt":
            return NSGT(num=self.num or 84, **band, **kw)
        if name == "cwt":
            return CWT(num=self.num or 84, wavelet_type=self.wavelet_type,
                       **band, **kw)
        if name == "pwt":
            return PWT(num=self.num or 84, **band, **kw)
        if name == "cqt":
            return CQT(num=84, samplate=self.samplate,
                       bin_per_octave=self.bin_per_octave,
                       slide_length=self.slide_length, device=self.device)
        if name == "st":
            return ST(radix2_exp=self.radix2_exp, device=self.device)
        if name == "fst":
            return FST(**kw)
        if name == "dwt":
            return DWT(num=self.num, **kw)
        return WPT(num=self.num, **kw)

    @staticmethod
    def _run_one(name, obj, x):
        if name == "bft":
            # complex matrix, like the reference facade's default bft()
            return obj.bft(x, result_type=0)
        if name in ("dwt", "wpt"):
            return getattr(obj, name)(x)[1]
        return getattr(obj, name)(x)

    # ------------------------------------------------------------------
    def spectrogram(self, data_arr, is_continue=False):
        """Run every transform; returns {name: FeatureResult} with key
        'spectrogram'.  Fixed-length transforms (cwt/pwt/st/fst/dwt/wpt)
        truncate the audio to 2**radix2_exp samples or zero-pad it."""
        x = as_tensor(data_arr, self.device)
        L = 1 << self.radix2_exp
        out = {}
        for name, obj in self._objs.items():
            xi = x
            if name in _FIXED_LENGTH:
                xi = (F.pad(x, (0, L - x.shape[-1])) if x.shape[-1] < L
                      else x[..., :L])
            r = FeatureResult(name)
            r["spectrogram"] = self._run_one(name, obj, xi)
            out[name] = r
        return out

    def spectral(self, spec_result, spectral, spectral_kw=None,
                 spec_convert=torch.abs):
        """Apply one Spectral feature to each transform's spectrogram."""
        spectral_kw = spectral_kw or {}
        out = {}
        for name, r in spec_result.items():
            spec = spec_convert(r["spectrogram"])
            num = spec.shape[-2]
            fre = np.asarray(self._objs[name].get_fre_band_arr(),
                             np.float32)[:num]
            sp = Spectral(num=num, fre_band_arr=fre, device=self.device)
            res = FeatureResult(name)
            res[spectral] = getattr(sp, spectral)(spec, **spectral_kw)
            out[name] = res
        return out

    def xxcc(self, spec_result, cc_num=13,
             rectify_type=CepstralRectifyType.LOG, spec_convert=torch.abs):
        out = {}
        for name, r in spec_result.items():
            spec = spec_convert(r["spectrogram"])
            res = FeatureResult(name)
            res["xxcc"] = XXCC(num=spec.shape[-2], device=self.device).xxcc(
                spec, cc_num, rectify_type)
            out[name] = res
        return out

    def deconv(self, spec_result, spec_convert=torch.abs):
        out = {}
        for name, r in spec_result.items():
            spec = spec_convert(r["spectrogram"])
            timbre, pitch = Deconv(num=spec.shape[-2],
                                   device=self.device).deconv(spec)
            res = FeatureResult(name)
            res["timbre"] = timbre
            res["pitch"] = pitch
            out[name] = res
        return out
