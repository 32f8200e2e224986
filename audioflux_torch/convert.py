"""Carry a TPU-package plan's constants into a port plan.

``load_reference_constants`` takes the numpy arrays of a JAX plan
(``.window``, ``.filter_bank``, ``._dct``, ``.chroma_filter_bank``; for a
streaming plan the carried ``tail`` and ``tail_len``) and installs them as
the port plan's constants and state, so that both packages can be shown to
compute the same thing from identical constants, also mid-stream.  It
takes arrays, not the JAX plan, so this package never imports the other.
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


def load_reference_constants(plan, *, window, filter_bank=None, dct=None,
                             chroma_filter_bank=None, tail=None,
                             tail_len=None):
    """Install a JAX plan's constants on the port plan and re-upload them
    to its device.  Shapes must match the plan's own constants.

    A ``Spectrogram`` plan takes ``window``/``filter_bank``/``dct`` (and
    the LOG_CHROMA fold ``chroma_filter_bank``); a plan without a
    filterbank (LINEAR) takes ``filter_bank=None``.  An ``STFT`` or
    ``HPSS`` plan carries only its ``window``.  ``tail`` and ``tail_len``
    copy the ``TailCarry`` state of a streaming plan (``is_continue`` or
    ``StreamingSTFT``)."""
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
