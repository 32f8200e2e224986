"""Shard, run, assemble: the helpers every sharded function shares.

One controller walks the mesh.  A sharded function splits its input along
the mesh axes, places each block on its device (:func:`place`), copies the
halos it needs from a neighbour's block to its own device, runs the port's
single-device code there (under :func:`on`, so that a kernel launches on
that device's current stream), and hands each shard's part to a sink: by
default an :class:`Assembler`, which copies it into one global result on
the mesh's first device; with ``keep_sharded=True`` a :class:`Shards`,
which leaves it on the device that computed it and returns a
:class:`ShardedTensor` (JAX's sharded ``jax.Array``, laid out by the
function's ``out_specs``).  A sharded function also takes a
:class:`ShardedTensor` whose mesh and spec are its JAX ``in_specs``
(:func:`sharded_input`); each shard then reads the part already on its
device and moves only what it needs from a neighbour
(:meth:`ShardedTensor.take`).  On a device that the mesh names more than
once, ``Tensor.to`` returns the block itself, so no step writes into a
block or a halo in place.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["on", "place", "gather", "Assembler", "replica", "check_2d",
           "tree_gather", "tree_shards", "MODES", "check_mode", "Shard",
           "ShardedTensor", "Shards", "sink", "sharded_input", "norm_spec",
           "position", "row_slices", "row_source", "spec_layout"]

MODES = ("auto", "gspmd", "shard_map")


def check_mode(mode: str) -> None:
    """Every mode but the CQT's ``"gspmd"`` (its frame-sharded form) runs
    the same explicit per-shard form; the argument is kept, and checked,
    so that callers of the JAX package's signatures keep working."""
    if mode not in MODES:
        raise ValueError(f"mode must be auto/gspmd/shard_map, got {mode!r}")


def on(dev: torch.device):
    """Make ``dev`` the current CUDA device (a no-op on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def place(x, dev: torch.device, dtype=torch.float32) -> torch.Tensor:
    """``x`` (host data or a tensor on any device) as ``dtype`` on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        device=dev, dtype=dtype)


def gather(parts, dim: int, dev: torch.device) -> torch.Tensor:
    """Concatenate ``parts`` in order along ``dim`` on ``dev``."""
    parts = [p.to(dev, non_blocking=True) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


class Assembler:
    """A global result on one device, each shard's part copied once into
    its place (no concatenation of concatenations).  The buffer is made
    when the first part arrives: ``shape`` is the global shape and
    ``index`` the part's place in it."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.out = None

    def put(self, part: torch.Tensor, index, shape, pos=None) -> None:
        """``pos``, the computing shard's mesh position, is for
        :class:`Shards`; here every part lands on ``dev``."""
        if self.out is None:
            self.out = torch.empty(shape, dtype=part.dtype, device=self.dev)
        self.out[index].copy_(part, non_blocking=True)


def position(mesh, **at) -> tuple:
    """The mesh coordinate with ``at[axis]`` on each named axis, 0 on the
    others, in ``mesh.axis_names`` order."""
    return tuple(int(at.get(a, 0)) for a in mesh.axis_names)


def norm_spec(spec, ndim: int) -> tuple:
    """``spec`` (JAX's ``PartitionSpec`` read as a tuple: a mesh axis name,
    a tuple of names or ``None`` per dimension) padded with ``None`` to
    ``ndim`` entries; a one-name tuple is the name."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out = []
    for e in spec + (None,) * (ndim - len(spec)):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            e = e[0] if len(e) == 1 else (e or None)
        out.append(e)
    return tuple(out)


def _bounds(index, shape):
    """A tuple of slices as ``[(start, stop)]`` over the global shape."""
    index = tuple(index) + (slice(None),) * (len(shape) - len(index))
    return [sl.indices(n)[:2] for sl, n in zip(index, shape)]


def _full_index(index, shape) -> tuple:
    """``index`` with a slice for every dimension: ``slice(None)`` for a
    whole dimension, ``slice(start, stop)`` for a part (JAX's
    ``Shard.index`` convention)."""
    return tuple(slice(None) if (a, b) == (0, n) else slice(a, b)
                 for (a, b), n in zip(_bounds(index, shape), shape))


def row_slices(n_rows: int, n: int):
    """``n`` row ranges of ``n_rows`` rows, ``np.array_split``'s sizes (the
    first ``n_rows % n`` one longer)."""
    q, r = divmod(n_rows, n)
    lo = [q * i + min(i, r) for i in range(n + 1)]
    return [slice(lo[i], lo[i + 1]) for i in range(n)]


def _split_rows(x, n: int):
    if isinstance(x, torch.Tensor):
        return torch.tensor_split(x, n, dim=0)
    return np.array_split(np.asarray(x, np.float32), n)


def row_source(x, n: int):
    """``(slices, rows_on)``: the row ranges of ``n`` data shards
    (``np.array_split``'s sizes) and ``rows_on(i, dev, cols)``, shard
    ``i``'s rows (their columns ``cols``) as float32 on ``dev``: a plain
    input's placed there, a ``ShardedTensor``'s read from the parts that
    hold them (nothing moves for a part already on ``dev``)."""
    sls = row_slices(x.shape[0], n)
    if isinstance(x, ShardedTensor):
        return sls, lambda i, dev, cols=slice(None): x.take(
            (sls[i], cols), dev, torch.float32)
    rows = _split_rows(x, n)
    return sls, lambda i, dev, cols=slice(None): place(
        rows[i] if cols == slice(None) else rows[i][:, cols], dev)


def spec_layout(mesh, spec, shape):
    """``[(position, index)]`` of ``spec`` over ``shape``: along a sharded
    dimension each of the ``k`` shards of its axes (row-major over a tuple
    of axes) holds ``ceil(n / k)`` entries, the last fewer.  A position
    that repeats an earlier one's index (an axis the spec leaves out) is
    dropped: a replicated value is held once, by the first device of
    that axis."""
    spec = norm_spec(spec, len(shape))
    seen, out = set(), []
    for pos in np.ndindex(*mesh.devices.shape):
        at = dict(zip(mesh.axis_names, pos))
        index = []
        for e, n in zip(spec, shape):
            if e is None:
                index.append(slice(None))
                continue
            axes = e if isinstance(e, tuple) else (e,)
            k, num = 0, 1
            for a in axes:
                k = k * mesh.shape[a] + at[a]
                num *= mesh.shape[a]
            blk = -(-n // num)
            index.append(slice(min(k * blk, n), min((k + 1) * blk, n)))
        index = _full_index(index, shape)
        key = tuple(sl.indices(n)[:2] for sl, n in zip(index, shape))
        if key not in seen:
            seen.add(key)
            out.append((tuple(pos), index))
    return out


class Shard(NamedTuple):
    """One part of a :class:`ShardedTensor` (named as JAX's
    ``addressable_shards``): ``data`` on ``device`` holds the global region
    ``index``, a tuple of slices with ``slice(None)`` for a whole
    dimension; ``position`` is the mesh coordinate of the shard that
    computed it (``mesh.devices[position]`` is ``device``)."""
    device: torch.device
    index: tuple
    data: torch.Tensor
    position: tuple


class ShardedTensor:
    """A global result whose parts stay on the devices that computed them:
    the port's counterpart of a sharded ``jax.Array``.

    ``mesh``; ``spec``, one entry per dimension (a mesh axis name, a tuple
    of names or ``None``, read as JAX's ``PartitionSpec``); ``shape``;
    ``dtype``; ``shards``, a list of :class:`Shard` in mesh order.  Where
    the spec leaves a mesh axis out (a value replicated over it), the
    value is held once per distinct index, on the first device of that
    axis: JAX keeps a copy on every device, and here a copy would only
    cost memory.  A mesh position with nothing to hold (a data row with no
    clips, a shard past the last valid frame) holds no shard.

    Not a ``torch.Tensor`` subclass and not a ``DTensor``: the port's mesh
    is one controller walking a grid that may name a device several times,
    with no process group.  :meth:`gather` makes one tensor;
    :meth:`take` reads any region from the shards that hold it."""

    def __init__(self, mesh, spec, shape, dtype, shards):
        self.mesh = mesh
        self.shape = tuple(int(n) for n in shape)
        self.spec = norm_spec(spec, len(self.shape))
        self.dtype = dtype
        self.shards = sorted(shards, key=lambda s: s.position)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def gather(self, device=None) -> torch.Tensor:
        """The global result as one tensor on ``device`` (the mesh's first
        device by default), each part copied once into its place: the
        copies the default call makes, so the same values bit for bit."""
        out = Assembler(self.mesh.first if device is None else device)
        for s in self.shards:
            out.put(s.data, s.index, self.shape)
        if out.out is None:
            return torch.empty(self.shape, dtype=self.dtype, device=out.dev)
        return out.out

    def take(self, index, device, dtype=None) -> torch.Tensor:
        """The global region ``index`` on ``device``, read from the shards
        that hold it: only the pieces that lie elsewhere move.  A region
        inside one shard is a view of it on its own device (no copy)."""
        box = _bounds(index, self.shape)
        dtype = self.dtype if dtype is None else dtype
        hits = []
        for s in self.shards:
            sb = _bounds(s.index, self.shape)
            cut = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(sb, box)]
            if all(lo < hi for lo, hi in cut):
                src = tuple(slice(lo - a, hi - a)
                            for (lo, hi), (a, _) in zip(cut, sb))
                dst = tuple(slice(lo - c, hi - c)
                            for (lo, hi), (c, _) in zip(cut, box))
                hits.append((s.data[src], dst))
        size = [hi - lo for lo, hi in box]
        if sum(t.numel() for t, _ in hits) != math.prod(size):
            raise ValueError(f"the shards of {self!r} do not hold the region "
                             f"{box} exactly once")
        if len(hits) == 1:
            return hits[0][0].to(device=device, dtype=dtype,
                                 non_blocking=True)
        out = torch.empty(size, dtype=dtype, device=device)
        for t, dst in hits:
            out[dst].copy_(t, non_blocking=True)
        return out

    def __repr__(self):
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec}, {len(self.shards)} shards)")


class Shards:
    """The ``keep_sharded=True`` sink: :meth:`put` keeps each part on its
    device, as a :class:`Shard` at the computing shard's mesh position;
    ``out`` is the :class:`ShardedTensor` (:class:`Assembler`'s
    interface)."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec
        self.shape = self.dtype = None
        self.parts = []

    def put(self, part: torch.Tensor, index, shape, pos) -> None:
        self.shape, self.dtype = tuple(shape), part.dtype
        self.parts.append(Shard(part.device, _full_index(index, shape), part,
                                tuple(pos)))

    @property
    def out(self) -> ShardedTensor:
        return ShardedTensor(self.mesh, self.spec, self.shape, self.dtype,
                             self.parts)


def sink(mesh, spec, keep_sharded: bool):
    """Where a sharded function's parts go: kept as they are
    (:class:`Shards`, ``spec``) or assembled on the mesh's first device
    (:class:`Assembler`)."""
    return Shards(mesh, spec) if keep_sharded else Assembler(mesh.first)


def _same_mesh(a, b) -> bool:
    return a is b or (a.axis_names == b.axis_names
                      and a.devices.shape == b.devices.shape
                      and all(str(u) == str(v) for u, v in
                              zip(a.devices.flat, b.devices.flat)))


def sharded_input(x, mesh, spec, what: str):
    """``x`` unchanged; a :class:`ShardedTensor` must lie on ``mesh`` with
    ``spec`` (the function's JAX ``in_specs``), else ``ValueError`` names
    both: a mismatched input is never gathered quietly."""
    if isinstance(x, ShardedTensor):
        want = norm_spec(spec, x.ndim)
        if x.spec != want or not _same_mesh(x.mesh, mesh):
            raise ValueError(f"{what}: the input is sharded as {x.spec} on "
                             f"{x.mesh!r}; this function takes {want} on "
                             f"{mesh!r}")
    return x


def tree_gather(trees, dim: int, dev: torch.device):
    """Concatenate the matching tensors of several nests along ``dim``."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_gather([t[k] for t in trees], dim, dev)
                for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_gather([t[i] for t in trees], dim, dev)
                           for i in range(len(first)))
    return gather(trees, dim, dev)


def tree_shards(trees, where, n_rows: int, mesh, axis: str):
    """The matching tensors of several nests as one ``ShardedTensor`` each,
    ``P(axis)``: ``where[k]`` is nest ``k``'s (row range, mesh position)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_shards([t[k] for t in trees], where, n_rows, mesh,
                               axis) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_shards([t[i] for t in trees], where, n_rows,
                                       mesh, axis)
                           for i in range(len(first)))
    out = Shards(mesh, (axis,))
    for t, (sl, pos) in zip(trees, where):
        out.put(t, (sl,), (n_rows,) + tuple(t.shape[1:]), pos)
    return out.out


def check_2d(x, n_rows: int, n_cols: int, what: str):
    """A (B, n) input whose batch divides ``n_rows`` and whose length
    divides ``n_cols`` (1: any length)."""
    shape = tuple(x.shape)
    if len(shape) != 2:
        raise ValueError(f"{what} expects (B, n) input, got {shape}")
    if shape[0] % n_rows:
        raise ValueError(f"batch {shape[0]} must divide the batch mesh "
                         f"axis ({n_rows})")
    if shape[1] % n_cols:
        raise ValueError(f"{what}: length {shape[1]} must divide the time "
                         f"mesh axis ({n_cols})")
    return shape


def replica(plan, dev: torch.device):
    """The plan with its device constants on ``dev``: the plan itself when
    it lives there, else a copy that re-uploads them (cached on the plan).
    Plans nested in the plan (a WSST's CWT, a CQT's resampler) follow."""
    if _same(plan.device, dev):
        return plan
    cache = plan.__dict__.setdefault("_replicas", {})
    rep = cache.get(str(dev))
    if rep is None:
        rep = copy.copy(plan)
        rep.__dict__ = {k: v for k, v in plan.__dict__.items()
                        if k != "_replicas"}
        rep.device = dev
        for k, v in list(rep.__dict__.items()):
            if isinstance(getattr(v, "device", None), torch.device) \
                    and hasattr(v, "__dict__") and not isinstance(
                        v, torch.Tensor):
                rep.__dict__[k] = replica(v, dev)
        if hasattr(rep, "_build_exec"):
            rep._build_exec()
        cache[str(dev)] = rep
    return rep


def _same(a: torch.device, b: torch.device) -> bool:
    if a.type != b.type:
        return False
    if a.type == "cpu":
        return True
    cur = torch.cuda.current_device
    return (a.index if a.index is not None else cur()) == (
        b.index if b.index is not None else cur())
