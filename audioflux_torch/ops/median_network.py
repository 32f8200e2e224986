"""The selection networks of the median kernel: one network for a run of
``m`` neighbouring windows, built here and emitted as a C++ header that
``csrc/median_filter.cu`` includes.  This module is the one source of both:
the kernel runs the operations listed here, in this order, and the CPU
tests apply the same list with numpy.

A thread of the kernel owns ``m`` consecutive outputs of a sliding median
of odd order ``w``.  Their windows cover ``w + m - 1`` taps; window ``j``
is taps ``j .. j + w - 1``.  The network shares the work of those windows
(the 1-D case of A. Adams, "Fast median filters using separable sorting
networks", ACM TOG 40(4), 2021):

* the taps common to all ``m`` windows (``w - m + 1``) are sorted once;
* the run splits in halves; each half's common taps are that sorted list
  merged with the few taps the half adds (sorted first, and shared with
  the other merges that sort the same taps), recursively down to single
  windows, whose median is one wire of their sorted list;
* at every step a sorted list keeps only the wires that can still be the
  median of every window it serves (a wire with more than ``rank`` wires
  below it is above the median; one with more than the window's remaining
  size above it is below), so merges shrink as they go down;
* merges are Batcher's odd-even merge for any two lengths, sorts Batcher's
  merge sort; the operations are values (SSA), shared when two merges ask
  for the same one, and pruned backwards from the ``m`` median wires, so a
  compare-exchange whose minimum (or maximum) no median needs costs one
  ``fmaxf`` (``fminf``) instead of both.

Every value the network computes is the minimum or the maximum of two
others, so its outputs are taps themselves: the order statistic of each
window, equal value for value to a full sort on input without NaN (±0 tie
and compare equal).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["Network", "build", "apply", "batcher_single_count", "header_text",
           "RUN", "INSTANCES"]

# outputs a thread of the kernel: of runs of 4, 8 and 16, 16 measured
# fastest on both of HPSS's axes (PERF.md)
RUN = 16
# (order, m) pairs compiled into the kernel: HPSS's default orders
INSTANCES = ((21, RUN), (31, RUN))


class Network:
    """A straight-line program over ``n_taps`` inputs: ``ops[i] = (kind, a,
    b)`` is value ``n_taps + i`` = ``min`` (kind 0) or ``max`` (kind 1) of
    values ``a`` and ``b``; ``outputs[j]`` is the value id of window ``j``'s
    median."""

    def __init__(self, order, m, n_taps, ops, outputs):
        self.order, self.m, self.n_taps = order, m, n_taps
        self.ops, self.outputs = ops, outputs

    @property
    def minmax(self) -> int:
        """min/max instructions of the whole network."""
        return len(self.ops)

    @property
    def compare_exchanges(self) -> int:
        """Pairs (a, b) of which the minimum, the maximum or both are
        kept."""
        return len({(a, b) for _, a, b in self.ops})

    @property
    def minmax_per_output(self) -> float:
        return self.minmax / self.m

    @property
    def ce_per_output(self) -> float:
        return self.compare_exchanges / self.m


class _Builder:
    def __init__(self, n_inputs):
        self.n = n_inputs
        self.ops = []
        self.memo = {}

    def _op(self, kind, a, b):
        if a > b:
            a, b = b, a
        key = (kind, a, b)
        v = self.memo.get(key)
        if v is None:
            v = self.n + len(self.ops)
            self.ops.append(key)
            self.memo[key] = v
        return v

    def ce(self, a, b):
        return self._op(0, a, b), self._op(1, a, b)

    def merge(self, A, B):
        """Batcher's odd-even merge of two sorted lists of any lengths."""
        A, B = tuple(A), tuple(B)
        return self._merge(A, B)

    def _merge(self, A, B):
        if not A:
            return list(B)
        if not B:
            return list(A)
        if len(A) == 1 and len(B) == 1:
            return list(self.ce(A[0], B[0]))
        E = self._merge(A[0::2], B[0::2])
        O = self._merge(A[1::2], B[1::2])
        inter = []
        for i in range(max(len(E), len(O))):
            if i < len(E):
                inter.append(E[i])
            if i < len(O):
                inter.append(O[i])
        for i in range(1, len(inter) - 1, 2):
            inter[i], inter[i + 1] = self.ce(inter[i], inter[i + 1])
        return inter

    def sort(self, L):
        """Batcher's merge sort (halves, then an odd-even merge)."""
        L = list(L)
        if len(L) <= 1:
            return L
        h = len(L) // 2
        return self.merge(self.sort(L[:h]), self.sort(L[h:]))


def _trim(S, rank, rest):
    """Keep the wires of the sorted list ``S`` that can be the ``rank``-th
    smallest of a window made of ``S`` and ``rest`` more values.  Returns
    (kept wires, the rank within them and ``rest``)."""
    S = S[:rank + 1]                     # more than rank wires below: above
    k = max(0, rank - rest)              # more than rest + ... above: below
    return S[k:], rank - k


def _run_network(order, m):
    """The shared network of ``m`` windows of ``order`` taps (before
    pruning)."""
    n_taps = order + m - 1
    b = _Builder(n_taps)
    outputs = [None] * m

    def common(lo, hi):
        # the taps windows lo .. hi-1 share: hi-1 .. lo+order-1 (or none)
        return range(hi - 1, max(hi - 1, lo + order))

    def solve(S, have, rank, lo, hi):
        # S: the sorted (trimmed) list of the taps `have`, which every
        # window lo .. hi-1 holds; its rank-th wire together with the
        # order - len(have) taps each window still adds is its median
        S, rank = _trim(S, rank, order - len(have))
        if hi - lo == 1:
            outputs[lo] = S[rank]
            return
        mid = (lo + hi) // 2
        for a, z in ((lo, mid), (mid, hi)):
            want = common(a, z)
            # the taps the half adds, sorted once (equal sorts are shared)
            new = [t for t in want if t not in have]
            solve(b.merge(S, b.sort(new)), want, rank, a, z)

    have = common(0, m)
    solve(b.sort(have), have, order // 2, 0, m)
    return n_taps, b.ops, outputs


def _prune(n_taps, ops, outputs):
    """Keep the operations the outputs need, renumbered in order."""
    need = [False] * (n_taps + len(ops))
    for v in outputs:
        need[v] = True
    for i in range(len(ops) - 1, -1, -1):
        if need[n_taps + i]:
            _, a, b = ops[i]
            need[a] = need[b] = True
    new_id = list(range(n_taps))
    kept = []
    for i, (kind, a, b) in enumerate(ops):
        if need[n_taps + i]:
            new_id.append(n_taps + len(kept))
            kept.append((kind, new_id[a], new_id[b]))
        else:
            new_id.append(None)
    return kept, [new_id[v] for v in outputs]


@functools.lru_cache(maxsize=None)
def build(order: int, m: int) -> Network:
    """The pruned network of a run of ``m`` windows of odd ``order``."""
    if order < 1 or order % 2 == 0 or m < 1:
        raise ValueError(f"need odd order >= 1 and m >= 1, got {order}, {m}")
    n_taps, ops, outputs = _run_network(order, m)
    ops, outputs = _prune(n_taps, ops, outputs)
    return Network(order, m, n_taps, ops, outputs)


def batcher_single_count(order: int) -> int:
    """Compare-exchanges of the kernel's network before runs of windows:
    Batcher's odd-even merge sort over one window padded to a power of two
    with +inf, pruned backwards from the median wire (149 at order 21, 157
    at order 31), each one ``fminf`` and one ``fmaxf``."""
    n = 1
    while n < order:
        n *= 2
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    needed = {order // 2}
    kept = 0
    for a, c in reversed(pairs):
        if a in needed or c in needed:
            needed |= {a, c}
            kept += 1
    return kept


def apply(net: Network, taps: np.ndarray) -> np.ndarray:
    """Run the network over ``taps[..., n_taps]`` -> ``(..., m)``."""
    taps = np.asarray(taps)
    if taps.shape[-1] != net.n_taps:
        raise ValueError(f"need {net.n_taps} taps, got {taps.shape[-1]}")
    vals = [taps[..., i] for i in range(net.n_taps)]
    for kind, a, b in net.ops:
        vals.append((np.minimum if kind == 0 else np.maximum)(vals[a],
                                                             vals[b]))
    return np.stack([vals[v] for v in net.outputs], axis=-1)


def header_text() -> str:
    """The C++ header of the kernel's networks: ``afx::kMedianRun`` (=
    ``RUN``) and one specialisation of ``afx::MedianRun<ORDER, M>`` per
    instance, whose ``run`` maps the taps t[0 .. ORDER + M - 2] to the M
    medians y[0 .. M - 1]."""
    lines = [
        "// Generated by audioflux_torch/ops/median_network.py: do not edit.",
        "#pragma once",
        "",
        "namespace afx {",
        "",
        f"constexpr int kMedianRun = {RUN};",
        "",
        "template <int ORDER, int M>",
        "struct MedianRun;",
    ]
    for order, m in INSTANCES:
        net = build(order, m)
        lines += [
            "",
            f"// {net.minmax} min/max instructions ({net.compare_exchanges} "
            f"compare-exchanges) for {m} windows of {order} taps:",
            f"// {net.minmax_per_output:.2f} min/max and "
            f"{net.ce_per_output:.2f} compare-exchanges an output",
            "template <>",
            f"struct MedianRun<{order}, {m}> {{",
            f"  static constexpr int kTaps = {net.n_taps};",
            f"  static constexpr int kMinMax = {net.minmax};",
            "  __device__ __forceinline__ static void run(",
            f"      const float (&t)[{net.n_taps}], float (&y)[{m}]) {{",
        ]

        def name(v):
            return f"t[{v}]" if v < net.n_taps else f"v{v}"
        for i, (kind, a, b) in enumerate(net.ops):
            fn = "fminf" if kind == 0 else "fmaxf"
            lines.append(f"    const float v{net.n_taps + i} = "
                         f"{fn}({name(a)}, {name(b)});")
        for j, v in enumerate(net.outputs):
            lines.append(f"    y[{j}] = {name(v)};")
        lines += ["  }", "};"]
    lines += ["", "}  // namespace afx", ""]
    return "\n".join(lines)
