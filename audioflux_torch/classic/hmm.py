"""Discrete HMM: forward/backward, Baum-Welch training, Viterbi decoding,
sampling.

Counterpart of ``audioflux_tpu/classic/hmm.py`` (reference
``src/classic/hmm.c``): unscaled forward/backward recursions (:606-656),
per-cell gamma/ksi normalization (:544-604), a train loop updating
(A, B, pi) until the parameter deltas fall below ``error``.  The
recursions are loops on the plan's device, one step a launch; the
convergence test is made on the host each iteration, as in the JAX
package.  The recursions are unscaled like the C's: over long sequences
they underflow to 0 (float32), as there.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.classic.viterbi import viterbi
from audioflux_torch.ops.backend import as_tensor, resolve_device

__all__ = ["HMM"]


def _forward(pi, A, Bo):
    alpha = torch.empty_like(Bo)
    alpha[0] = pi * Bo[0]
    for t in range(1, Bo.shape[0]):
        alpha[t] = (alpha[t - 1] @ A) * Bo[t]
    return alpha


def _backward(A, Bo):
    beta = torch.empty_like(Bo)
    beta[-1] = 1.0
    for t in range(Bo.shape[0] - 2, -1, -1):
        beta[t] = A @ (Bo[t + 1] * beta[t + 1])
    return beta


class HMM:
    """API mirrors ``python/audioflux/classic`` HMM usage (hmm.h:15-29),
    plus ``device`` (``None`` means ``cuda``).  The parameters stay host
    float32 arrays (``pi``, ``A``, ``B``), as in the JAX package."""

    def __init__(self, s_length: int, n_length: int, seed: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.s_length = s_length
        self.n_length = n_length
        rng = np.random.default_rng(seed)

        def row_stochastic(shape):
            m = rng.random(shape)
            return (m / m.sum(axis=-1, keepdims=True)).astype(np.float32)

        self.pi = row_stochastic((s_length,))
        self.A = row_stochastic((s_length, s_length))
        self.B = row_stochastic((s_length, n_length))

    def init(self, pi_arr, m_a_arr, m_b_arr):
        self.pi = np.asarray(pi_arr, np.float32)
        self.A = np.asarray(m_a_arr, np.float32)
        self.B = np.asarray(m_b_arr, np.float32)

    def _obs(self, o_arr):
        return torch.as_tensor(np.asarray(o_arr, np.int64),
                               device=self.device)

    # ------------------------------------------------------------------
    def predict(self, o_arr) -> float:
        """Observation-sequence likelihood via the forward recursion."""
        Bo = as_tensor(self.B, self.device)[:, self._obs(o_arr)].T
        alpha = _forward(as_tensor(self.pi, self.device),
                         as_tensor(self.A, self.device), Bo.contiguous())
        return float(torch.sum(alpha[-1]))

    def decode(self, o_arr):
        """(state path, probability) via Viterbi."""
        s, p, _ = viterbi(self.pi, self.A, self.B, o_arr, device=self.device)
        return s.cpu().numpy(), float(p)

    # ------------------------------------------------------------------
    def train(self, o_arr, max_iter: int = 100, error: float = 1e-3):
        """Baum-Welch reestimation on one observation sequence."""
        dev = self.device
        o = self._obs(o_arr)
        pi = as_tensor(self.pi, dev)
        A = as_tensor(self.A, dev)
        B = as_tensor(self.B, dev)
        onehot = torch.nn.functional.one_hot(o, self.n_length).to(
            torch.float32)

        def em(pi, A, B):
            Bo = B[:, o].T.contiguous()  # (T, S)
            alpha = _forward(pi, A, Bo)
            beta = _backward(A, Bo)
            ab = alpha * beta  # (T, S)
            gamma = ab / torch.sum(ab, dim=-1, keepdim=True)
            # ksi[t,i,j] ~ alpha[t,i] A[i,j] Bo[t+1,j] beta[t+1,j]
            num = (alpha[:-1, :, None] * A[None]
                   * (Bo[1:] * beta[1:])[:, None, :])
            ksi = num / torch.sum(num, dim=(1, 2), keepdim=True)
            A_new = (torch.sum(ksi, dim=0)
                     / torch.sum(gamma[:-1], dim=0)[:, None])
            B_new = (gamma.T @ onehot) / torch.sum(gamma, dim=0)[:, None]
            pi_new = gamma[0]
            return pi_new, A_new, B_new

        for _ in range(max_iter):
            pi_n, A_n, B_n = em(pi, A, B)
            d = max(float(torch.linalg.norm(pi_n - pi)),
                    float(torch.linalg.norm(A_n - A)),
                    float(torch.linalg.norm(B_n - B)))
            pi, A, B = pi_n, A_n, B_n
            if d < error:
                break
        self.pi = pi.cpu().numpy()
        self.A = A.cpu().numpy()
        self.B = B.cpu().numpy()

    # ------------------------------------------------------------------
    def generate(self, t_length: int, seed: int = 0):
        """Sample (observations, states) from the model (host numpy, the
        JAX package's draws from the same seed)."""
        rng = np.random.default_rng(seed)
        states = np.zeros(t_length, np.int64)
        obs = np.zeros(t_length, np.int64)
        s = rng.choice(self.s_length, p=self.pi / self.pi.sum())
        for t in range(t_length):
            states[t] = s
            obs[t] = rng.choice(self.n_length,
                                p=self.B[s] / self.B[s].sum())
            s = rng.choice(self.s_length, p=self.A[s] / self.A[s].sum())
        return obs, states
