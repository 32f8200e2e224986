"""Viterbi decoding.

Counterpart of ``audioflux_tpu/classic/viterbi.py`` (reference
``src/classic/viterbi.c``): probability-domain (or log-domain with 1e-16
flooring) maximization recursion; the reference resolves the state path
as the per-frame argmax of the probability matrix (:__viterbi + "find
hidden states" loop), not by backtracking — reproduced as-is.  The JAX
package's ``lax.scan`` is a loop on the device, one step a launch (a
step depends on the one before; the JAX package has no kernel for it).
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops.backend import as_tensor, resolve_device

__all__ = ["viterbi"]


def viterbi(pi_arr, m_a_arr, m_b_arr, o_arr=None, is_log: bool = False,
            device=None):
    """Returns (s_arr, prob, m_prob_arr): the state path (T,) int64, its
    final probability (a 0-dim tensor) and the (T, S) probability matrix,
    on ``device`` (``None`` means ``cuda``).

    pi (S,), A (S, S), B (S, N), observations o (T,) int.
    """
    dev = resolve_device(device)
    pi = as_tensor(pi_arr, dev)
    A = as_tensor(m_a_arr, dev)
    B = as_tensor(m_b_arr, dev)
    S, N = B.shape
    if o_arr is None:
        o_arr = np.arange(N)
    o = torch.as_tensor(np.asarray(o_arr, np.int64), device=dev)

    if is_log:
        pi = torch.log(pi + 1e-16)
        A = torch.log(A + 1e-16)
        B = torch.log(B + 1e-16)

    Bo = B[:, o].T.contiguous()  # (T, S)
    T = Bo.shape[0]
    probs = torch.empty((T, S), dtype=torch.float32, device=dev)
    probs[0] = (pi + Bo[0]) if is_log else (pi * Bo[0])
    for t in range(1, T):
        prev = probs[t - 1]
        if is_log:
            probs[t] = torch.amax(prev[:, None] + A, dim=0) + Bo[t]
        else:
            probs[t] = torch.amax(prev[:, None] * A, dim=0) * Bo[t]
    s_arr = torch.argmax(probs, dim=-1)
    prob = probs[-1, s_arr[-1]]
    return s_arr, prob, probs
