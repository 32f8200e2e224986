"""Carry a TPU-package plan's constants into a port plan.

``load_reference_constants`` takes the numpy arrays of a JAX plan
(``.window``, ``.filter_bank``, ``._dct``, ``.chroma_filter_bank``; for a
streaming plan the carried ``tail`` and ``tail_len``; for a ``CWT``,
``PWT`` or ``WSST`` plan the wavelet banks, band arrays and support rows;
for a ``Reassign`` plan its three windows; for a ``CQT`` plan its kernels,
its resampler's tap table, DCT and scale vector; for a ``Spectral`` plan
its band frequencies; for an ``ST`` plan its windows, for an ``NSGT`` plan
its windows, offsets and expansion index, for a ``DWT``/``WPT``/``SWT``
plan its decomposition taps, for a ``DeepSpectrogram`` or
``DeepChromaSpectrogram`` plan its window and chroma fold) and installs
them as the port plan's constants and state, so that both packages can be
shown to compute the same thing from identical constants, also
mid-stream.  It takes arrays, not the JAX plan, so this package never
imports the other.
"""

from __future__ import annotations

import numpy as np

from audioflux_torch.features.spectral import Spectral
from audioflux_torch.ops.backend import as_tensor
from audioflux_torch.transforms.bft import BFT
from audioflux_torch.transforms.cqt import CQTBase
from audioflux_torch.transforms.deep import (DeepChromaSpectrogram,
                                             _DeepBase)
from audioflux_torch.transforms.dwt import _Wavelet
from audioflux_torch.transforms.nsgt import NSGT
from audioflux_torch.transforms.reassign import Reassign, reassign_windows
from audioflux_torch.transforms.st import ST

__all__ = ["load_reference_constants"]


def _same_shape(name, new, old):
    new = np.asarray(new, np.float32)
    if old is None or new.shape != np.shape(old):
        raise ValueError(f"{name}: shape {new.shape} does not match the "
                         f"plan's {None if old is None else np.shape(old)}")
    return new


def _load_wavelet(plan, bank, det_bank, fre_band_arr, bin_band_arr, row_h,
                  det_row_h):
    """Install a JAX ``CWT``/``PWT`` plan's banks and band arrays.  The
    support rows are not installed but held against the port's own count
    of the new bank: they tell the kernel which zeros to skip, so the two
    packages must agree on them."""
    plan._bank = _same_shape("bank", bank, plan._bank)
    if det_bank is not None:
        plan.enable_det(True)
        plan._det_bank = _same_shape("det_bank", det_bank, plan._det_bank)
    if fre_band_arr is not None:
        plan.fre_band_arr = _same_shape("fre_band_arr", fre_band_arr,
                                        plan.fre_band_arr)
    if bin_band_arr is not None:
        plan.bin_band_arr = np.asarray(bin_band_arr)
    plan._build_exec()
    for name, given, own in (("row_h", row_h, plan._row_h),
                             ("det_row_h", det_row_h,
                              getattr(plan, "_det_row_h", None))):
        if given is not None and tuple(given) != tuple(own or ()):
            raise ValueError(f"{name}: {tuple(given)} differs from the "
                             f"port's count {own}")
    return plan


def _load_cqt(plan, kernels, resample_filts, dct, scale_vec):
    """Install a JAX ``CQT``/``VQT`` plan's per-octave kernels (complex),
    the tap table of its 2:1 resampler (``_resampler._plan().filts``), its
    DCT and its scale vector (``_scale_vec()``)."""
    if kernels is not None:
        if len(kernels) != len(plan._kernels):
            raise ValueError(f"kernels: {len(kernels)} octaves, the plan "
                             f"has {len(plan._kernels)}")
        new = []
        for k, own in zip(kernels, plan._kernels):
            k = np.asarray(k, np.complex64)
            if k.shape != own.shape:
                raise ValueError(f"kernels: shape {k.shape} does not match "
                                 f"the plan's {own.shape}")
            new.append(k)
        plan._kernels = new
    if resample_filts is not None:
        rs = plan._resampler._plan()
        rs.filts = _same_shape("resample_filts", resample_filts, rs.filts)
        rs.mat = as_tensor(rs.window_matrix(), plan.device)
    if dct is not None:
        plan._dct = _same_shape("dct", dct, plan._dct)
    if scale_vec is not None:
        plan._scale = _same_shape("scale_vec", scale_vec, plan._scale)
    plan._build_exec()
    return plan


def _load_nsgt(plan, windows, offsets, expand):
    """Install a JAX ``NSGT`` plan's per-band windows (``_windows``), slice
    offsets (``_offsets``) and expansion index (``_expand``)."""
    if windows is not None:
        if len(windows) != plan.num:
            raise ValueError(f"windows: {len(windows)} bands, the plan has "
                             f"{plan.num}")
        plan._windows = [_same_shape(f"windows[{i}]", w, own)
                         for i, (w, own) in enumerate(zip(windows,
                                                          plan._windows))]
    if offsets is not None:
        if len(offsets) != plan.num:
            raise ValueError(f"offsets: {len(offsets)} bands, the plan has "
                             f"{plan.num}")
        plan._offsets = [int(v) for v in offsets]
    if expand is not None:
        expand = np.asarray(expand, np.int64)
        if expand.shape != plan._expand.shape:
            raise ValueError(f"expand: shape {expand.shape} does not match "
                             f"the plan's {plan._expand.shape}")
        plan._expand = expand
    plan._build_exec()
    return plan


def load_reference_constants(plan, *, window=None, filter_bank=None, dct=None,
                             chroma_filter_bank=None, tail=None,
                             tail_len=None, bank=None, det_bank=None,
                             fre_band_arr=None, bin_band_arr=None,
                             row_h=None, det_row_h=None, wins=None,
                             kernels=None, resample_filts=None,
                             scale_vec=None, windows=None, offsets=None,
                             expand=None, lo_d=None, hi_d=None):
    """Install a JAX plan's constants on the port plan and re-upload them
    to its device.  Shapes must match the plan's own constants.

    A ``Spectrogram`` plan takes ``window``/``filter_bank``/``dct`` (and
    the LOG_CHROMA fold ``chroma_filter_bank``); a plan without a
    filterbank (LINEAR) takes ``filter_bank=None``.  An ``STFT`` or
    ``HPSS`` plan carries only its ``window``.  ``tail`` and ``tail_len``
    copy the ``TailCarry`` state of a streaming plan (``is_continue`` or
    ``StreamingSTFT``).  A ``CWT`` or ``PWT`` plan (a ``WSST`` plan: its
    inner CWT) takes ``bank`` (rows ascending in frequency, the JAX plan's
    ``_bank``), ``det_bank``, ``fre_band_arr``, ``bin_band_arr`` and the
    JAX plan's ``_row_h``/``_det_row_h``, which must equal the port's own
    count.  A ``BFT`` plan takes ``window`` (its reassignment windows are
    derived from it) and ``filter_bank`` (``None`` for LINEAR); a
    ``Reassign`` plan ``wins``, the stacked (h, dh, th) of the JAX plan's
    ``_wins``; a ``CQT``/``VQT`` plan ``kernels``, ``resample_filts``,
    ``dct`` and ``scale_vec``; a ``Spectral`` plan ``fre_band_arr``.  An
    ``ST`` plan takes ``windows`` (the JAX plan's ``_windows``); an
    ``NSGT`` plan ``windows`` (its list of per-band windows), ``offsets``
    and ``expand``; a ``DWT``, ``WPT`` or ``SWT`` plan ``lo_d`` and
    ``hi_d``; a ``DeepSpectrogram`` plan ``window``, a
    ``DeepChromaSpectrogram`` plan also ``chroma_filter_bank`` (the JAX
    plan's ``_fold``)."""
    if isinstance(plan, ST):
        plan._windows = _same_shape("windows", windows, plan._windows)
        plan._build_exec()
        return plan
    if isinstance(plan, NSGT):
        return _load_nsgt(plan, windows, offsets, expand)
    if isinstance(plan, _Wavelet):
        plan.lo_d = _same_shape("lo_d", lo_d, plan.lo_d)
        plan.hi_d = _same_shape("hi_d", hi_d, plan.hi_d)
        plan._build_exec()
        return plan
    if isinstance(plan, _DeepBase):
        if window is not None:
            plan.window = _same_shape("window", window, plan.window)
        if isinstance(plan, DeepChromaSpectrogram) and (
                chroma_filter_bank is not None):
            plan._fold = _same_shape("chroma_filter_bank",
                                     chroma_filter_bank, plan._fold)
        plan._build_exec()
        return plan
    if isinstance(plan, Spectral):
        plan.fre_band_arr = _same_shape("fre_band_arr", fre_band_arr,
                                        plan.fre_band_arr)
        plan._build_exec()
        return plan
    if isinstance(plan, CQTBase):
        return _load_cqt(plan, kernels, resample_filts, dct, scale_vec)
    if isinstance(plan, BFT):
        if filter_bank is not None or plan.filter_bank is not None:
            plan.filter_bank = _same_shape("filter_bank", filter_bank,
                                           plan.filter_bank)
        plan._re._wins = np.stack(reassign_windows(_same_shape(
            "window", window, plan._re._wins[0])))
        plan._re._build_exec()
        plan._build_exec()
        return plan
    if isinstance(plan, Reassign):
        plan._wins = _same_shape("wins", wins, plan._wins)
        plan._build_exec()
        return plan
    wavelet = getattr(plan, "_cwt", plan)               # WSST -> its CWT
    if hasattr(wavelet, "_bank"):
        _load_wavelet(wavelet, bank, det_bank, fre_band_arr, bin_band_arr,
                      row_h, det_row_h)
        return plan
    # every plan keeps its numpy constants and uploads them in _build_exec
    target = plan._stft if hasattr(plan, "_stft") else plan  # StreamingSTFT
    target.window = _same_shape("window", window, target.window)
    if hasattr(target, "_dct"):         # the Spectrogram family
        if filter_bank is not None or target.filter_bank is not None:
            target.filter_bank = _same_shape("filter_bank", filter_bank,
                                             target.filter_bank)
        target._dct = _same_shape("dct", dct, target._dct)
        if (chroma_filter_bank is not None
                or target.chroma_filter_bank is not None):
            target.chroma_filter_bank = _same_shape(
                "chroma_filter_bank", chroma_filter_bank,
                target.chroma_filter_bank)
    target._build_exec()
    if tail_len is not None:
        carry = plan._carry
        if carry is None:
            raise ValueError("the plan carries no tail (is_continue is off)")
        carry.tail_len = int(tail_len)
        carry.tail = (as_tensor(np.asarray(tail, np.float32), plan.device)
                      if carry.tail_len > 0 else None)
    return plan
