"""Sharded full-signal transforms: bands or bins over the mesh.

Counterpart of ``audioflux_tpu/parallel/sharded_full.py``.  CWT/PWT, ST,
FST and NSGT take one FFT of the whole ``2**radix2_exp``-sample signal and
then one inverse transform per band (reference ``cwt_algorithm.c:418-456``,
``st_algorithm.c:262-286``, ``nsgt_algorithm.c:542-620``).  The forward FFT
is one L·log L pass, cheaper to repeat than to send, so every shard
repeats it; the bands, where the work is, split over the ``time`` mesh
axis (the band axis, as in the JAX package's twins), the batch over
``data``.  Each shard runs the port's single-device code on its own band
rows, so that every kernel launches once per shard at the shard's shape
(``cwt_ifft_bank`` on only that shard's bank rows, their support counted
on the slice), and the global result is assembled on the mesh's first
device.  With ``keep_sharded=True`` every function here returns a
``ShardedTensor`` (``parallel/_shard.py``) laid out by the JAX twin's
``out_specs`` instead, each part left on the device that computed it: a
long ``ccwt`` that fits the mesh's devices together but not one of them
runs.  Every one also takes a ``ShardedTensor`` laid out by the JAX
twin's ``in_specs`` (``P(batch, None)`` for the band family, ``P(batch,
time)`` for the splice), each shard reading its rows or block where they
lie.  Where the band count does not divide the band axis, JAX's slice of
its zero-padded bands hands back another sharding than its ``out_specs``
(30 bands over 4 shards: two parts of 15, each on two devices); a kept
result follows the ``out_specs``, ``ceil(num / n)`` bands a shard, the
last fewer.

Synchrosqueezing: each band shard maps its cells to output bins
(``synsq_bins`` for Synsq, the analytic map for WSST) and scatters them into
a full-size partial (``columnar_scatter``); by default the partials are
summed on the first device in shard order.  With ``keep_sharded=True``
they are reduce-scattered along the output's time axis, as JAX's
``psum_scatter`` does: band shard ``j`` of a data row ends with time
slice ``j``, the sum in shard order of every partial's slice ``j``, and
only those slices cross devices (so the kept result gathers to the
default one bit for bit).  The sum order differs from the unsharded
call's.  Order > 1 composes the bin maps of every band, so those maps are
gathered, composed and sliced back in both modes.

``sharded_ccwt_fn``/``sharded_cst_fn`` split long recordings in time
instead: the reference's half-overlap window splice, each shard computing
its own windows from its block and two halos (``fft_length // 2`` to the
left, ``fft_length // 2`` to the right); a block must be a multiple of
``fft_length // 2``.

The CQT has two forms.  ``mode="gspmd"`` is JAX's frame-sharded GSPMD
form, the single-signal scale-out path: the batch splits over ``data``,
each time shard takes the whole signal of its clips, runs the resample
chain itself (JAX's deliberate signal replication) and computes only its
own range of output frames in every octave (``CQT._cqt_frames``).
``"auto"`` and ``"shard_map"`` run the batch form over the whole mesh.
JAX's ``_twin_or_auto`` picks per call instead (``"auto"``: the batch
twin when the plan's top-octave FFT reaches its kernel tier and B divides
the mesh, else the GSPMD form); here the caller picks, so that a call's
form never depends on the batch it is given.

Not ported, by design (each served SPMD tracing or the TPU runtime): the
GSPMD forms other than the CQT's, and ``_pin_native_fft``; the ``mode``
dispatch (``_pick_smap``, ``_twin_or_auto``): every mode but the CQT's
``"gspmd"`` runs the explicit per-shard form, ``mode`` is checked and
kept for callers' keywords;
``_uniform_row_h`` (``shard_map`` traces one program for every shard, so
the row counts were the maximum over shards: here each shard counts its
own); the uniform Bluestein rewrite of NSGT's ragged band inverses
(SPMD needs one shape: each shard here runs the port's per-length
inverses on its bands); ``check_vma``; the ``interpret`` argument (kept,
unused); the complex tables split into float pairs for the TPU host link.
"""

from __future__ import annotations

import numpy as np
import torch

from audioflux_torch.ops.backend import as_tensor
from audioflux_torch.ops.cuda_cwt import band_row_counts
from audioflux_torch.ops.cuda_scatter import MAX_OUT_SIZE
from audioflux_torch.ops.cuda_unwrap import synsq_bins
from audioflux_torch.ops.scatter import columnar_scatter_add
from audioflux_torch.parallel._shard import (Shards, check_2d, check_mode,
                                             gather, on, position, replica,
                                             row_source, sharded_input, sink,
                                             tree_gather, tree_shards)
from audioflux_torch.parallel.mesh import Mesh
from audioflux_torch.transforms.cwt import _cwt_conv_body
from audioflux_torch.transforms.nsgt import _nsgt_body
from audioflux_torch.transforms.st import _st_body
from audioflux_torch.transforms.synsq import (_compose_order,
                                              _reassign_scatter, scale_kind)
from audioflux_torch.transforms.wsst import _wsst_map

__all__ = ["sharded_cwt_fn", "sharded_pwt_fn", "sharded_synsq_fn",
           "sharded_wsst_fn", "sharded_st_fn", "sharded_fst_fn",
           "sharded_nsgt_fn", "sharded_cqt_fn", "sharded_ccwt_fn",
           "sharded_cst_fn", "sharded_batch_fn", "sharded_batch_map_fn"]


def _band_slices(num: int, nshard: int):
    """The band rows of each shard: ``ceil(num / nshard)`` each, the
    JAX twins' split (the last shards may hold fewer, or none)."""
    nloc = -(-num // nshard)
    return [slice(min(j * nloc, num), min((j + 1) * nloc, num))
            for j in range(nshard)]


class _BandShards:
    """Per (band shard, device): a plan's constants for its band rows."""

    def __init__(self, mesh: Mesh, batch_axis: str, band_axis: str,
                 num: int, make):
        self.mesh, self.axes = mesh, (batch_axis, band_axis)
        self.grid = mesh.grid(batch_axis, band_axis)
        self.first = mesh.first
        self.slices = _band_slices(num, self.grid.shape[1])
        self._make = make
        self._cache = {}

    def consts(self, j: int, dev):
        key = (j, str(dev))
        if key not in self._cache:
            self._cache[key] = self._make(self.slices[j], dev)
        return self._cache[key]

    def pos(self, i: int, j: int) -> tuple:
        return position(self.mesh, **dict(zip(self.axes, (i, j))))

    def run(self, x, body, what: str, n_len=None, keep_sharded=False):
        """``body(x_ij, consts, dev)`` on every (data shard, band shard)
        with bands; the results concatenated along the band axis (-2) and
        then the batch (``keep_sharded``: kept, ``P(batch, band, None)``).
        The input may be a ``ShardedTensor`` ``P(batch, None)``."""
        x = sharded_input(x, self.mesh, (self.axes[0], None), what)
        n_b = self.grid.shape[0]
        B, n = check_2d(x, n_b, 1, what)
        if n_len is not None and n != n_len:
            raise ValueError(f"{what}: data length must be exactly {n_len}")
        sls, rows_on = row_source(x, n_b)
        out = sink(self.mesh, self.axes + (None,), keep_sharded)
        num = self.slices[-1].stop
        for i in range(n_b):
            r0 = sls[i].start
            for j, sl in enumerate(self.slices):
                if sl.start == sl.stop:
                    continue
                dev = self.grid[i, j]
                xi = rows_on(i, dev)
                with on(dev):
                    part = body(xi, self.consts(j, dev), dev)
                out.put(part, (slice(r0, r0 + part.shape[0]), sl),
                        (B, num) + tuple(part.shape[2:]), self.pos(i, j))
        return out.out


def _bank_consts(bank: np.ndarray):
    """A bank's rows for one shard on its device, with their support row
    counts (the kernel's ``row_h``) counted on the slice."""
    w_len = bank.shape[1]

    def make(sl, dev):
        rows = np.ascontiguousarray(bank[sl])
        row_h = (torch.tensor(band_row_counts(rows, w_len), dtype=torch.int32,
                              device=dev)
                 if w_len & (w_len - 1) == 0 else None)
        return as_tensor(rows, dev), row_h
    return make


def _conv(obj, consts, x, det):
    bank, row_h = consts
    return _cwt_conv_body(x, bank, det=det, pad_length=obj.pad_length,
                          data_length=obj.data_length, row_h=row_h)


def _cwt_like(obj, bank, mesh, batch_axis, band_axis, det, what, keep):
    shards = _BandShards(mesh, batch_axis, band_axis, bank.shape[0],
                         _bank_consts(bank))

    def run(x):
        return shards.run(x, lambda xi, c, dev: _conv(obj, c, xi, det), what,
                          obj.data_length, keep)
    return run


def sharded_cwt_fn(obj, mesh: Mesh, batch_axis: str = "data",
                   time_axis: str = "time", det: bool = False,
                   mode: str = "auto", interpret: bool = False,
                   keep_sharded: bool = False):
    """Band-sharded CWT: (B, 2**radix2_exp) -> complex64 (B, num, L) on the
    mesh's first device, equal to ``obj.cwt`` (``obj.cwt_det`` with
    ``det``) to float rounding.  B must divide the ``data`` axis; the
    bands split over ``time_axis``, ``ceil(num / n)`` a shard, the last
    fewer (``keep_sharded``: a ``ShardedTensor``, ``P(batch, time,
    None)``).  Every ``mode`` runs this form."""
    check_mode(mode)
    if det:
        obj.enable_det(True)
    return _cwt_like(obj, obj._det_bank if det else obj._bank, mesh,
                     batch_axis, time_axis, det, "sharded cwt", keep_sharded)


def sharded_pwt_fn(obj, mesh: Mesh, batch_axis: str = "data",
                   time_axis: str = "time", mode: str = "auto",
                   interpret: bool = False, keep_sharded: bool = False):
    """Band-sharded PWT: (B, data_length) -> complex64 (B, num, L); the
    same pipeline as the CWT with the PWT's bank.  Equal to ``obj.pwt``
    to float rounding."""
    check_mode(mode)
    return _cwt_like(obj, obj._bank, mesh, batch_axis, time_axis, False,
                     "sharded pwt", keep_sharded)


def _squeeze_fn(cwt_obj, mesh, batch_axis, band_axis, *, kind, num_out,
                samplate, thresh, order, with_det, what, keep_sharded):
    """The Synsq/WSST body: band-sharded CWT (and derivative CWT), bin map
    per shard, partial scatter per shard, partials summed on the first
    device in shard order (``keep_sharded``: reduce-scattered along time).
    Returns ``run(x)`` -> squeezed (and the CWT when ``with_det``)."""
    bank = cwt_obj._bank
    if with_det:
        cwt_obj.enable_det(True)
    make_b = _bank_consts(bank)
    make_d = _bank_consts(cwt_obj._det_bank) if with_det else None
    fre = np.asarray(cwt_obj.fre_band_arr, np.float32)

    def make(sl, dev):
        return (make_b(sl, dev), make_d(sl, dev) if with_det else None,
                as_tensor(fre, dev))

    shards = _BandShards(mesh, batch_axis, band_axis, bank.shape[0], make)
    grid, first = shards.grid, mesh.first
    n_t = grid.shape[1]
    fused = not with_det and order == 1 and num_out <= MAX_OUT_SIZE

    def bins(D, dD, fre_t):
        if with_det:
            return _wsst_map(D, dD, fre_t, scale_kind=kind, num=num_out,
                             samplate=samplate)
        if fused:   # one pass to the drop-coded bin (dropped: num_out)
            return synsq_bins(D.contiguous(), fre_t, kind, num_out, samplate,
                              thresh)
        return synsq_bins(D.contiguous(), fre_t, kind, num_out, samplate)

    def partial(D, fi):
        return (columnar_scatter_add(D, fi, num_out) if fused
                else _reassign_scatter(D, fi, num=num_out, thresh=thresh))

    def reduce_scatter(cells, i):
        """Band shard ``j`` of data row ``i`` gets time slice ``j`` of the
        partials' sum, in shard order; only those slices move."""
        acc = {}
        for dev, D, fi in cells:
            with on(dev):
                part = partial(D, fi)
            for j, tl in enumerate(_band_slices(part.shape[-1], n_t)):
                if tl.start == tl.stop:
                    continue
                piece = part[..., tl].to(grid[i, j], non_blocking=True)
                acc[j] = piece if j not in acc else acc[j] + piece
        return acc, part.shape

    def run(x):
        x = sharded_input(x, mesh, (batch_axis, None), what)
        n_b = grid.shape[0]
        B, n = check_2d(x, n_b, 1, what)
        if n != cwt_obj.data_length:
            raise ValueError(f"{what}: data length must be exactly "
                             f"{cwt_obj.data_length}")
        sls, rows_on = row_source(x, n_b)
        sq_out = sink(mesh, (batch_axis, None, band_axis), keep_sharded)
        d_out = sink(mesh, (batch_axis, band_axis, None), keep_sharded)
        for i in range(n_b):
            r0, b = sls[i].start, sls[i].stop - sls[i].start
            cells = []      # (dev, D, fi) of each band shard
            js = []         # the band shards with bands
            for j, sl in enumerate(shards.slices):
                if sl.start == sl.stop:
                    continue
                js.append(j)
                dev = grid[i, j]
                xi = rows_on(i, dev)
                cb, cd, fre_t = shards.consts(j, dev)
                with on(dev):
                    D = _conv(cwt_obj, cb, xi, False)
                    dD = _conv(cwt_obj, cd, xi, True) if with_det else None
                    cells.append((dev, D, bins(D, dD, fre_t)))
            if order > 1:
                # the composition looks up other bands' targets
                fi_all = _compose_order(
                    gather([c[2] for c in cells], -2, first), num_out, order)
                splits = [c[2].shape[-2] for c in cells]
                cells = [(dev, D, fi.to(dev, non_blocking=True))
                         for (dev, D, _), fi in zip(
                             cells, fi_all.split(splits, dim=-2))]
            if keep_sharded:
                acc, shape = reduce_scatter(cells, i)
                for j, tl in enumerate(_band_slices(shape[-1], n_t)):
                    if j in acc:
                        sq_out.put(acc[j], (slice(r0, r0 + b), slice(None),
                                            tl), (B,) + tuple(shape[1:]),
                                   shards.pos(i, j))
            else:
                sq = None
                for dev, D, fi in cells:
                    with on(dev):
                        part = partial(D, fi)
                    part = part.to(first, non_blocking=True)
                    sq = part if sq is None else sq + part
                sq_out.put(sq, slice(r0, r0 + b), (B,) + tuple(sq.shape[1:]))
            if with_det:
                for j, (_, D, _) in zip(js, cells):
                    d_out.put(D, (slice(r0, r0 + b), shards.slices[j]),
                              (B, bank.shape[0]) + tuple(D.shape[2:]),
                              shards.pos(i, j))
        return (sq_out.out, d_out.out) if with_det else sq_out.out

    return run


def sharded_synsq_fn(cwt_obj, synsq_obj, mesh: Mesh,
                     batch_axis: str = "data", time_axis: str = "time",
                     mode: str = "auto", interpret: bool = False,
                     keep_sharded: bool = False):
    """Band-sharded CWT + synchrosqueezing: (B, L) -> complex64
    (B, num, L), equal to ``synsq_obj.synsq(cwt_obj.cwt(x), ...)`` up to
    the order of each output bin's sum over bands (``keep_sharded``: a
    ``ShardedTensor``, ``P(batch, None, time)``, reduce-scattered)."""
    check_mode(mode)
    return _squeeze_fn(cwt_obj, mesh, batch_axis, time_axis,
                       kind=scale_kind(cwt_obj.scale_type),
                       num_out=synsq_obj.num,
                       samplate=float(synsq_obj.samplate),
                       thresh=synsq_obj.thresh, order=synsq_obj.order,
                       with_det=False, what="sharded synsq",
                       keep_sharded=keep_sharded)


def sharded_wsst_fn(wsst_obj, mesh: Mesh,
                    batch_axis: str = "data", time_axis: str = "time",
                    mode: str = "auto", interpret: bool = False,
                    keep_sharded: bool = False):
    """Band-sharded WSST: (B, L) -> (squeezed, cwt), both (B, num, L),
    equal to ``wsst_obj.wsst`` up to each output bin's sum order
    (``keep_sharded``: ``P(batch, None, time)`` and ``P(batch, time,
    None)``)."""
    check_mode(mode)
    return _squeeze_fn(wsst_obj._cwt, mesh, batch_axis, time_axis,
                       kind=scale_kind(wsst_obj.scale_type),
                       num_out=wsst_obj.num,
                       samplate=float(wsst_obj.samplate),
                       thresh=wsst_obj.thresh, order=wsst_obj.order,
                       with_det=True, what="sharded wsst",
                       keep_sharded=keep_sharded)


def sharded_st_fn(obj, mesh: Mesh, batch_axis: str = "data",
                  time_axis: str = "time", mode: str = "auto",
                  keep_sharded: bool = False):
    """Bin-sharded Stockwell transform: (B, L) -> complex64 (B, nbins, L);
    each shard inverts its own bins' windowed shifted spectra (the FFT
    kernels at 2048..32768 on the card).  Equal to ``obj.st``."""
    check_mode(mode)
    bins = np.asarray(obj.bin_arr, np.int64)
    L = obj.fft_length

    def make(sl, dev):
        b = bins[sl]
        zero = np.flatnonzero(b == 0)
        return (as_tensor(obj._windows[sl], dev),
                torch.from_numpy(b[:, None] + np.arange(L)[None, :]).to(dev),
                torch.from_numpy(zero).to(dev) if len(zero) else None)

    shards = _BandShards(mesh, batch_axis, time_axis, len(bins), make)
    return lambda x: shards.run(
        x, lambda xi, c, dev: _st_body(xi, *c), "sharded st", L,
        keep_sharded)


def sharded_fst_fn(obj, mesh: Mesh, batch_axis: str = "data",
                   time_axis: str = "time", min_index: int = None,
                   max_index: int = None, mode: str = "auto",
                   keep_sharded: bool = False):
    """Band-sharded fast S-transform: (B, L) -> complex64 (B, nbins, L).
    The segment chain (about L values) is repeated on every shard; each
    shard gathers only its own bands of the expansion, so the result is
    equal to ``obj.fst`` bit for bit."""
    check_mode(mode)
    if min_index is None:
        min_index = obj.min_index
    if max_index is None:
        max_index = obj.max_index
    rows = obj._gather_rows(min_index, max_index)
    shards = _BandShards(mesh, batch_axis, time_axis, rows.shape[0],
                         lambda sl, dev: torch.from_numpy(
                             np.ascontiguousarray(rows[sl])).to(dev))
    return lambda x: shards.run(
        x, lambda xi, g, dev: obj._fst_chain(xi)[..., g], "sharded fst",
        obj.fft_length, keep_sharded)


def sharded_nsgt_fn(obj, mesh: Mesh, batch_axis: str = "data",
                    time_axis: str = "time", mode: str = "auto",
                    keep_sharded: bool = False):
    """Band-sharded NSGT: (B, 2**radix2_exp) -> complex64 (B, num,
    max_time_length); each shard runs the port's per-length band inverses
    on its bands.  Equal to ``obj.nsgt`` to float rounding."""
    check_mode(mode)
    shards = _BandShards(mesh, batch_axis, time_axis, obj.num,
                         lambda sl, dev: obj._band_plan(
                             range(sl.start, sl.stop), dev))
    return lambda x: shards.run(
        x, lambda xi, c, dev: _nsgt_body(xi, *c), "sharded nsgt",
        obj.fft_length, keep_sharded)


def sharded_cqt_fn(obj, mesh: Mesh, batch_axis: str = "data",
                   time_axis: str = "time", mode: str = "auto",
                   keep_sharded: bool = False):
    """Mesh-parallel CQT/VQT: (B, n) -> complex64 (B, num, T), equal to
    ``obj.cqt`` to float rounding.

    ``mode="auto"``/``"shard_map"``: the batch form.  Each of the ``data *
    time`` shards runs the plan's whole single-device CQT (the resample
    chain and every octave's frames) on its clips, an even split where B
    allows it (any B: a shard may get one clip fewer, or none);
    ``keep_sharded``: ``P((batch, time))``.

    ``mode="gspmd"``: the frame form (JAX's single-signal scale-out path),
    for any B, B = 1 included.  The batch splits over ``data`` as evenly
    as it allows; each time shard takes the whole signal of its clips and
    runs the resample chain itself (JAX's deliberate replication: the
    signal is small beside the framed octaves), then frames and
    transforms only its own output frames, ``ceil(T / time)`` a shard,
    the last fewer; ``keep_sharded``: ``P(batch, None, time)``.  JAX
    hands this form back replicated over ``time`` (its spec is a
    constraint inside the graph, not the output's); a kept result
    follows the spec.  JAX's ``"auto"`` picks a form per call
    (``_twin_or_auto``); here the caller picks it with ``mode``.

    The input may be a ``ShardedTensor``: ``P((batch, time))`` for the
    batch form, ``P(batch, time)`` for the frame form (each time shard
    then reads its clips' other blocks from their devices)."""
    check_mode(mode)
    if obj.is_continue:
        raise ValueError("sharded_cqt_fn does not support is_continue mode")
    if mode == "gspmd":
        return _cqt_frames_fn(obj, mesh, batch_axis, time_axis, keep_sharded)
    grid = mesh.grid(batch_axis, time_axis)
    devs, n_t = grid.reshape(-1), grid.shape[1]

    def run(x):
        x = sharded_input(x, mesh, ((batch_axis, time_axis),), "sharded cqt")
        if x.ndim != 2:
            raise ValueError(f"sharded cqt expects (B, n) input, got "
                             f"{tuple(x.shape)}")
        sls, rows_on = row_source(x, len(devs))
        out = (Shards(mesh, ((batch_axis, time_axis), None, None))
               if keep_sharded else None)
        parts = []
        for k, (dev, sl) in enumerate(zip(devs, sls)):
            if sl.start == sl.stop:
                continue
            with on(dev):
                part = replica(obj, dev).cqt(rows_on(k, dev))
            if out is None:
                parts.append(part)
            else:
                out.put(part, (sl,), (x.shape[0],) + tuple(part.shape[1:]),
                        position(mesh, **{batch_axis: k // n_t,
                                          time_axis: k % n_t}))
        return gather(parts, 0, mesh.first) if out is None else out.out

    return run


def _cqt_frames_fn(obj, mesh: Mesh, batch_axis: str, time_axis: str,
                   keep_sharded: bool):
    """The frame form of :func:`sharded_cqt_fn`."""
    grid = mesh.grid(batch_axis, time_axis)
    n_b, n_t = grid.shape

    def run(x):
        x = sharded_input(x, mesh, (batch_axis, time_axis),
                          "sharded cqt (frames)")
        if x.ndim != 2:
            raise ValueError(f"sharded cqt expects (B, n) input, got "
                             f"{tuple(x.shape)}")
        B, n = x.shape
        T = n // obj.slide_length + 1
        sls, rows_on = row_source(x, n_b)
        out = sink(mesh, (batch_axis, None, time_axis), keep_sharded)
        for i, sl in enumerate(sls):
            if sl.start == sl.stop:
                continue
            for j, tl in enumerate(_band_slices(T, n_t)):
                if tl.start == tl.stop:
                    continue
                dev = grid[i, j]
                with on(dev):
                    part = replica(obj, dev)._cqt_frames(
                        rows_on(i, dev), tl.start, tl.stop)
                out.put(part, (sl, slice(None), tl), (B, obj.num, T),
                        position(mesh, **{batch_axis: i, time_axis: j}))
        return out.out

    return run


def _spliced_sharded_fn(transform, L: int, mesh: Mesh, batch_axis: str,
                        time_axis: str, what: str, keep_sharded: bool):
    """Time-sharded half-overlap window splice, generic over the per-window
    transform ``transform(dev)(windows)``: (B, W, L) -> (B, W, num, L).

    Each time shard owns ``m = block / step`` windows (``step = L / 2``);
    the two that straddle its edges need ``step`` samples of the left
    block and ``L - step`` of the right one.  Window ids are global and
    clipped to ``[0, wc - 1]``, so an edge shard recomputes one window
    instead of branching; the splice keeps each window's middle half, the
    first window's head and the last one's tail.  ``keep_sharded``: a
    ``ShardedTensor``, ``P(batch, None, time)``; the input may be one,
    ``P(batch, time)``, each block read where it lies."""
    win_len = L // 4
    step = win_len * 2

    def run(x):
        x = sharded_input(x, mesh, (batch_axis, time_axis), what)
        grid = mesh.grid(batch_axis, time_axis)
        n_b, n_t = grid.shape
        B, n = check_2d(x, n_b, n_t, what)
        M = n // n_t
        if M % step:
            raise ValueError(f"per-shard length {M} must be a multiple of "
                             f"fft_length//2 = {step}")
        m = M // step
        if n_t * m < 2:
            raise ValueError(f"signal too short for {what}: {n} samples "
                             f"< {2 * step}")
        wc = n_t * m - 1                      # global window count
        sls, rows_on = row_source(x, n_b)
        out = sink(mesh, (batch_axis, None, time_axis), keep_sharded)
        for i in range(n_b):
            blocks = [rows_on(i, grid[i, j], slice(j * M, (j + 1) * M))
                      for j in range(n_t)]
            r0, b = sls[i].start, sls[i].stop - sls[i].start
            for j in range(n_t):
                dev = grid[i, j]
                left = blocks[(j - 1) % n_t][:, -step:].to(dev,
                                                           non_blocking=True)
                right = blocks[(j + 1) % n_t][:, :L - step].to(
                    dev, non_blocking=True)
                with on(dev):
                    ext = torch.cat([left, blocks[j], right], dim=-1)
                    jm = j * m
                    g = np.clip(jm - 1 + np.arange(m + 1), 0, wc - 1)
                    offs = (g - (jm - 1)) * step
                    base = torch.from_numpy(
                        offs[:, None] + np.arange(L)[None, :]).to(dev)
                    spec = transform(dev)(ext[..., base])  # (B, m+1, num, L)
                    first = (spec[..., 0, :, 0:win_len] if j == 0 else
                             spec[..., 0, :, 2 * win_len:3 * win_len])
                    last = (spec[..., m, :, 3 * win_len:4 * win_len]
                            if j == n_t - 1 else
                            spec[..., m, :, win_len:2 * win_len])
                    mid = spec[..., 1:m, :, win_len:3 * win_len]
                    mid = mid.movedim(-3, -2).reshape(
                        mid.shape[:-3] + (mid.shape[-2],
                                          (m - 1) * 2 * win_len))
                    part = torch.cat([first, mid, last], dim=-1)
                    del spec
                out.put(part, (slice(r0, r0 + b), slice(None),
                               slice(j * M, (j + 1) * M)),
                        (B, part.shape[1], n),
                        position(mesh, **{batch_axis: i, time_axis: j}))
        return out.out

    return run


def sharded_ccwt_fn(obj, mesh: Mesh, batch_axis: str = "data",
                    time_axis: str = "time", keep_sharded: bool = False):
    """Time-sharded continuous CWT over long recordings: (B, n) ->
    complex64 (B, num, n), n a multiple of ``time * fft_length // 2``;
    equal to ``obj.ccwt`` to float rounding (the same windows, computed
    per shard).  ``keep_sharded``: ``P(batch, None, time)``, no device
    holding more than its own part."""
    return _spliced_sharded_fn(lambda dev: replica(obj, dev).cwt,
                               obj.fft_length, mesh, batch_axis, time_axis,
                               "sharded ccwt", keep_sharded)


def sharded_cst_fn(obj, mesh: Mesh, batch_axis: str = "data",
                   time_axis: str = "time", keep_sharded: bool = False):
    """Time-sharded continuous Stockwell transform (``ST.cst``'s splice),
    distributed as :func:`sharded_ccwt_fn`; equal to ``obj.cst`` to float
    rounding (the bin-0 row is the per-window mean)."""
    return _spliced_sharded_fn(lambda dev: replica(obj, dev).st,
                               obj.fft_length, mesh, batch_axis, time_axis,
                               "sharded cst", keep_sharded)


def _batch_fn(fn, mesh: Mesh, batch_axis: str, strict: bool,
              keep_sharded: bool):
    devs = mesh.grid(batch_axis, _other(mesh, batch_axis))[:, 0]

    def run(x):
        x = sharded_input(x, mesh, (batch_axis,), "sharded batch")
        n_b = len(devs)
        if strict and x.shape[0] % n_b:
            raise ValueError(f"batch {x.shape[0]} must divide the "
                             f"'{batch_axis}' mesh axis ({n_b})")
        sls, rows_on = row_source(x, n_b)
        outs, where = [], []
        for i, (dev, sl) in enumerate(zip(devs, sls)):
            if sl.start == sl.stop:
                continue
            with on(dev):
                outs.append(fn(rows_on(i, dev)))
            where.append((sl, position(mesh, **{batch_axis: i})))
        if keep_sharded:
            return tree_shards(outs, where, x.shape[0], mesh, batch_axis)
        return tree_gather(outs, 0, mesh.first)

    return run


def _other(mesh: Mesh, axis: str) -> str:
    return next(a for a in mesh.axis_names if a != axis)


def sharded_batch_fn(fn, mesh: Mesh, batch_axis: str = "data",
                     keep_sharded: bool = False):
    """Run a leading-batch function once per ``batch_axis`` shard, on the
    shard's first device, with the batch split as evenly as it allows;
    ``fn`` maps (B, ...) to a nest of tensors with leading axis B, which
    are concatenated on the mesh's first device (``keep_sharded``: a nest
    of ``ShardedTensor``s, ``P(batch)``, each part on its row's first
    device).  Bit-equal to ``fn`` on the whole batch wherever ``fn``
    treats clips independently.  The input may be a ``ShardedTensor``
    ``P(batch)``."""
    return _batch_fn(fn, mesh, batch_axis, False, keep_sharded)


def sharded_batch_map_fn(fn, mesh: Mesh, batch_axis: str = "data",
                         keep_sharded: bool = False):
    """:func:`sharded_batch_fn` whose batch must divide the
    ``batch_axis`` size, as the JAX ``shard_map`` form asks: ``fn`` (a
    kernel-bearing pipeline such as ``HPSS.hpss`` or ``PitchYIN.pitch``)
    runs once per shard on exactly its rows."""
    return _batch_fn(fn, mesh, batch_axis, True, keep_sharded)
