"""Carry a TPU-package plan's constants into a port plan.

``load_reference_constants`` takes the numpy arrays of a JAX plan
(``.window``, ``.filter_bank``, ``._dct``, ``.chroma_filter_bank``; for a
streaming plan the carried ``tail`` and ``tail_len``; for a ``CWT``,
``PWT`` or ``WSST`` plan the wavelet banks, band arrays and support rows)
and installs them as the port plan's constants and state, so that both
packages can be shown to compute the same thing from identical constants,
also mid-stream.  It takes arrays, not the JAX plan, so this package never
imports the other.
"""

from __future__ import annotations

import numpy as np

from audioflux_torch.ops.backend import as_tensor

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


def load_reference_constants(plan, *, window=None, filter_bank=None, dct=None,
                             chroma_filter_bank=None, tail=None,
                             tail_len=None, bank=None, det_bank=None,
                             fre_band_arr=None, bin_band_arr=None,
                             row_h=None, det_row_h=None):
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
    count."""
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
