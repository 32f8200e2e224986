"""Sinc/Kaiser polyphase resampling.

Counterpart of ``audioflux_tpu/dsp/resample.py`` (reference
``src/dsp/resample_algorithm.c``): a windowed-sinc interpolation table
(zeroNum zero-crossings x 2^nbit samples each, Kaiser window, roll-off
scaled; :_calInterpArr) evaluated per output sample with linear table
interpolation (:_resampleObj_resample).  Quality presets Best/Mid/Fast set
(zeroNum, beta, rollOff) = (64,14.7697,.9476)/(32,11.6626,.8988)/
(16,8.5555,.85) (:54-90).

For a rational ratio p/q the tap phase repeats every p outputs: output
``k*p + r`` is the dot product of phase r's taps with the input from
``k*q + base_r + 1`` on.  Shifting each phase's taps by its ``base_r``
puts all p phases on one input window per k, so the whole resampler is one
strided ``unfold`` of the padded input and one fp32 matrix product with a
(window, p) tap matrix, whose columns come out already interleaved.  It
holds where a phase's taps are shorter than the stride q too (a window
then covers q + taps - 1 samples).  A plain ``conv1d`` would run under
cuDNN's TF32 default on the card; the matrix product follows
``torch.backends.cuda.matmul.allow_tf32``, which stays False.

The C computes each output's phase as ``float t=i/ratio`` (float32,
resample_algorithm.c:483), so its interpolation phase carries a rounding
jitter that grows with the output index; the exact rational phases here
do not, so outputs agree with the C to ~1e-5 for small p (2:1) but only
to ~4e-3 on long signals at large-p ratios (441/640).
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch
import torch.nn.functional as F

from audioflux_torch.observe import scope
from audioflux_torch.ops.backend import as_tensor, f32_scalar, resolve_device
from audioflux_torch.ops.window import get_window
from audioflux_torch.types import ResampleQualityType, WindowType

__all__ = ["Resample", "WindowResample", "resample"]

_QUALITY = {
    ResampleQualityType.BEST: (64, 9, 14.7696565, 0.9475937),
    ResampleQualityType.MID: (32, 9, 11.6625806, 0.8987969),
    ResampleQualityType.FAST: (16, 9, 8.5555046, 0.85),
}


def _interp_table(zero_num: int, nbit: int, window_type: WindowType,
                  value: float, roll_off: float) -> np.ndarray:
    """The right-half windowed-sinc table (resample_algorithm.c:546-632)."""
    bit_length = 1 << nbit
    n = zero_num * bit_length + 1
    x = np.linspace(0.0, zero_num, n) * roll_off
    s = np.sinc(x) * roll_off  # np.sinc = sin(pi x)/(pi x)
    win = get_window(window_type, 2 * (n - 1) + 1, periodic=False,
                     alpha=value, dtype=np.float64)
    return (s * win[n - 1:]).astype(np.float64)


class _Plan:
    """Per-(p, q) tap vectors: phase r covers outputs i = k*p + r and
    starts ``base[r] + 1`` samples into the padded input."""

    def __init__(self, interp: np.ndarray, bit_length: int, p: int, q: int,
                 ratio: float):
        interp = interp * ratio if ratio < 1 else interp
        delta = np.append(np.diff(interp), 0.0)
        n_interp = len(interp)
        scale = min(1.0, ratio)
        step = int(np.floor(np.float32(scale) * bit_length))

        max_l = n_interp // step + 1
        self.p, self.q = p, q
        self.base = [int(math.floor(r * q / p)) for r in range(p)]
        filts = []
        for r in range(p):
            frac = r * q / p - self.base[r]
            filt = np.zeros(2 * max_l, np.float64)
            # left taps (applied to x[n], x[n-1], ...)
            fv = scale * frac * bit_length
            off = int(np.floor(fv))
            d = fv - off
            for j in range((n_interp - off) // step):
                filt[max_l - 1 - j] = (interp[off + j * step]
                                       + d * delta[off + j * step])
            # right taps (applied to x[n+1], x[n+2], ...)
            fv = (scale - scale * frac) * bit_length
            off = int(np.floor(fv))
            d = fv - off
            for j in range((n_interp - off) // step):
                filt[max_l + j] = (interp[off + j * step]
                                   + d * delta[off + j * step])
            filts.append(filt)
        self.max_l = max_l
        self.filts = np.stack(filts).astype(np.float32)  # (p, taps)

    def window_matrix(self) -> np.ndarray:
        """(window, p) taps, phase r's column shifted down by base[r]: one
        input window per k serves all p phases."""
        taps = self.filts.shape[-1]
        mat = np.zeros((taps + self.base[-1], self.p), np.float32)
        for r, b in enumerate(self.base):
            mat[b:b + taps, r] = self.filts[r]
        return mat


def _poly_resample(x: torch.Tensor, mat: torch.Tensor, *, p: int, q: int,
                   out_len: int, max_l: int) -> torch.Tensor:
    """(..., n) -> (..., out_len): the strided windows of the padded input
    (window k starts at k*q + 1) times the (window, p) tap matrix."""
    win = mat.shape[0]
    K = -(-out_len // p)                    # windows: ceil(out_len / p)
    need = 1 + (K - 1) * q + win            # padded samples they read
    right = max(need - max_l - x.shape[-1], 0)
    xp = F.pad(x, (max_l, right))[..., 1:need]
    y = torch.matmul(xp.unfold(-1, win, q), mat)    # (..., K, p)
    return y.reshape(x.shape[:-1] + (K * p,))[..., :out_len]


class WindowResample:
    """Custom-window resampler
    (``python/audioflux/dsp/resample.py:160`` / resampleObj_newWithWindow),
    plus ``device`` (``None`` means ``cuda``)."""

    def __init__(self, zero_num: int = 64, nbit: int = 9,
                 win_type: WindowType = WindowType.HANN,
                 value: float = None, roll_off: float = 0.945,
                 is_scale: bool = False, is_continue: bool = False,
                 tail_carry: bool = False, device=None):
        window_type = win_type
        if value is None or value < 0:
            value = {WindowType.KAISER: 5.0,
                     WindowType.GAUSS: 2.5}.get(WindowType(window_type), 0.0)
        self.device = resolve_device(device)
        self.zero_num = int(zero_num)
        self.nbit = int(nbit)
        self.bit_length = 1 << self.nbit
        self.window_type = WindowType(window_type)
        self.value = float(value)
        self.roll_off = float(roll_off)
        self.is_scale = bool(is_scale)
        self.is_continue = bool(is_continue)
        # The reference's streaming tail carry is dead code: the tail store
        # (resample_algorithm.c:377-383) is guarded by dealArr, which is
        # only non-NULL once a tail exists (:416), so each chunk's
        # remainder is dropped.  The default does the same; tail_carry=True
        # carries the remainder into the next call instead (each chunk is
        # still filtered with zero history at its edges, as in the C).
        self.tail_carry = bool(tail_carry)
        self._interp = _interp_table(self.zero_num, self.nbit,
                                     self.window_type, self.value,
                                     self.roll_off)
        self.ratio = 0.5
        self.p, self.q = 1, 2
        self._plans = {}
        self._tail = None

    def set_samplate(self, source_rate: int, target_rate: int):
        if source_rate == target_rate or source_rate <= 0 or target_rate <= 0:
            return
        f = Fraction(target_rate, source_rate)
        self.p, self.q = f.numerator, f.denominator
        self.ratio = target_rate / source_rate

    def enable_continue(self, flag: bool):
        """Toggle streaming mode; resets the carried tail
        (resampleObj_enableContinue, resample_algorithm.c:334-341)."""
        if not flag:
            self._tail = None
        self.is_continue = bool(flag)

    def cal_data_length(self, data_length: int) -> int:
        if self.is_continue and self.q > 1:
            # streaming: the source is cut to a multiple of the down factor
            # (resample_algorithm.c:235-244)
            src = data_length - data_length % self.q
            return src * self.p // self.q
        return int(np.floor(data_length * self.ratio))

    def _plan(self):
        """The (p, q) plan: numpy taps and their window matrix on the
        device, made once per ratio."""
        key = (self.p, self.q, round(self.ratio, 12))
        if key not in self._plans:
            plan = _Plan(self._interp, self.bit_length, self.p, self.q,
                         self.ratio)
            plan.mat = as_tensor(plan.window_matrix(), self.device)
            self._plans[key] = plan
        return self._plans[key]

    def resample(self, data_arr):
        """(..., n) -> (..., floor(n*ratio)).

        With ``is_continue`` (1-D input only): the source is cut to a
        multiple of the down factor per chunk (resample_algorithm.c:
        235-244); the remainder is dropped as in the C, or carried into the
        next call when ``tail_carry=True``.
        """
        with scope(f"af.{type(self).__name__}.resample"):
            x = as_tensor(data_arr, self.device)
            if self.is_continue and self.q > 1:
                if x.ndim != 1:
                    raise ValueError(
                        "is_continue streaming expects 1-D input")
                if self.tail_carry and self._tail is not None:
                    x = torch.cat([self._tail, x])
                n = x.shape[-1] - x.shape[-1] % self.q
                if self.tail_carry:
                    self._tail = x[n:].clone()
                x = x[:n]
                out_len = n * self.p // self.q
            else:
                out_len = int(np.floor(x.shape[-1] * self.ratio))
            plan = self._plan()
            y = _poly_resample(x, plan.mat, p=plan.p, q=plan.q,
                               out_len=out_len, max_l=plan.max_l)
            if self.is_scale:
                y = y / f32_scalar(np.sqrt(self.ratio), y.device)
            return y


class Resample(WindowResample):
    """Quality-preset resampler (``python/audioflux/dsp/resample.py:118``),
    plus ``device``."""

    def __init__(self, qual_type: ResampleQualityType = ResampleQualityType.BEST,
                 is_scale: bool = False, is_continue: bool = False,
                 tail_carry: bool = False, device=None):
        zero_num, nbit, beta, roll_off = _QUALITY[ResampleQualityType(qual_type)]
        super().__init__(zero_num=zero_num, nbit=nbit,
                         win_type=WindowType.KAISER, value=beta,
                         roll_off=roll_off, is_scale=is_scale,
                         is_continue=is_continue, tail_carry=tail_carry,
                         device=device)


def resample(x, source_samplate: int, target_samplate: int,
             re_type: str = "scipy"):
    """Module-level resample with the signature and semantics of the
    reference's free function (``audio.py:176-222``: scipy-based,
    downsampling only).  It runs scipy on the host and returns numpy; the
    :class:`Resample` class runs on a device and also upsamples."""
    import scipy.signal
    x = np.asarray(x, dtype=np.float32, order="C")
    if target_samplate == source_samplate:
        return x
    if not 8000 <= target_samplate < source_samplate:
        raise ValueError(
            f"target_samplate[{target_samplate}] must be between 8000 to "
            f"source_samplate[{source_samplate}]")
    if re_type == "scipy":
        num = int(np.ceil(x.shape[-1]
                          * (target_samplate * 1.0 / source_samplate)))
        return scipy.signal.resample(x, num, axis=-1)
    if re_type == "scipy_poly":
        gcd = np.gcd(source_samplate, target_samplate)
        return scipy.signal.resample_poly(x, up=target_samplate // gcd,
                                          down=source_samplate // gcd,
                                          axis=-1)
    raise ValueError(f"re_type[{re_type}] not supported")
