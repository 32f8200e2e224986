"""Device resolution and the kernel tier's hardware check.

The policy has no silent fallback:

* a plan or one-shot given ``device=None`` runs on ``cuda``; with no CUDA
  device it raises instead of quietly running on the CPU — the caller
  asks for the CPU explicitly with ``device="cpu"``;
* a kernel wrapper takes its plain PyTorch version only for a tensor that
  lies on the CPU; a CUDA tensor launches the hand-written kernel, which
  needs an sm_90 card (:func:`require_sm90`) or raises.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "require_sm90", "as_tensor", "host_f32",
           "f32_scalar"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def require_sm90(device: torch.device) -> None:
    """The kernels are built for ``sm_90a`` only; refuse any other card."""
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the CUDA kernels need an sm_90 (Hopper) card; "
            f"{torch.cuda.get_device_name(device)} is sm_{cap[0]}{cap[1]}")


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """float32 tensor on ``device``.  Host data (numpy, lists) is uploaded;
    a tensor that already lies on another device is refused, so that no
    call moves a caller's data between the card and the CPU unasked."""
    if isinstance(x, torch.Tensor):
        if x.device.type != device.type:
            raise ValueError(f"tensor on {x.device}, plan on {device}")
        return x.to(device=device, dtype=torch.float32)
    x = np.asarray(x, dtype=np.float32)
    if not x.flags.writeable:  # e.g. a read-only view of another library's buffer
        x = x.copy()
    return torch.from_numpy(x).to(device)


def host_f32(x) -> np.ndarray:
    """float32 numpy array of ``x`` (a tensor on any device, or host
    data), for the host stages of the engines that walk frames on the
    host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def f32_scalar(value: float, device) -> torch.Tensor:
    """``float32(value)`` as a 0-dim tensor on ``device``.  Dividing by it
    is a true IEEE division on both devices; dividing a CUDA tensor by a
    Python number multiplies by the reciprocal instead, which differs from
    the CPU's quotient on knife-edge cells."""
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)
