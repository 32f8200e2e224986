"""Carry a TPU-package plan's constants into a port plan.

``load_reference_constants`` takes the numpy arrays of a JAX plan
(``.window``, ``.filter_bank``, ``._dct``, ``.chroma_filter_bank``) and
installs them as the port plan's constants, so that both packages can be
shown to compute the same thing from identical constants.  It takes
arrays, not the JAX plan, so this package never imports the other.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_reference_constants"]


def _same_shape(name, new, old):
    new = np.asarray(new, np.float32)
    if old is None or new.shape != np.shape(old):
        raise ValueError(f"{name}: shape {new.shape} does not match the "
                         f"plan's {None if old is None else np.shape(old)}")
    return new


def load_reference_constants(plan, *, window, filter_bank, dct,
                             chroma_filter_bank=None):
    """Install ``window``/``filter_bank``/``dct`` (and the LOG_CHROMA fold
    ``chroma_filter_bank``) on a ``Spectrogram`` plan and re-upload them
    to its device.  Shapes must match the plan's own constants; a plan
    without a filterbank (LINEAR) takes ``filter_bank=None``."""
    plan.window = _same_shape("window", window, plan.window)
    if filter_bank is not None or plan.filter_bank is not None:
        plan.filter_bank = _same_shape("filter_bank", filter_bank,
                                       plan.filter_bank)
    plan._dct = _same_shape("dct", dct, plan._dct)
    if chroma_filter_bank is not None or plan.chroma_filter_bank is not None:
        plan.chroma_filter_bank = _same_shape(
            "chroma_filter_bank", chroma_filter_bank, plan.chroma_filter_bank)
    plan._build_exec()
    return plan
