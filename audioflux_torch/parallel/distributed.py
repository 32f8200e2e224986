"""Multi-process execution: ``torch.distributed`` start-up and
process-local feeding.

Counterpart of ``audioflux_tpu/parallel/distributed.py``.  Scope: the
``data`` mesh axis may span processes; the time, band and pipe axes stay
inside one process.  Each process builds the mesh of its own devices,
feeds its own rows of the global batch (:func:`global_from_local`; with
``keep_sharded=True`` a ``ShardedTensor`` placed by the spec, which any
sharded function whose ``in_specs`` is that spec reads where it lies),
runs the sharded functions on them, and :func:`process_allgather` joins
the processes' results.

Backends: NCCL when each process has a card of its own, gloo otherwise
(the CPU, or two processes sharing one card).  The caller may name the
backend; the choice is printed, never made silently.  Gloo's collectives
take CPU tensors, so a gloo gather of CUDA results goes through the host
(a device-to-host copy before the collective, host-to-device after).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from audioflux_torch.parallel._shard import Shards, place, spec_layout
from audioflux_torch.parallel.mesh import Mesh

__all__ = ["initialize", "is_initialized", "global_from_local",
           "process_barrier", "process_allgather", "backend"]


def _pick_backend(num_processes: int) -> str:
    """NCCL when every process of this host can have a card of its own."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= num_processes:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None, backend: str | None = None,
               timeout_s: int = 120):
    """Start the process group and barrier until every process arrives.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` URL) of
    process 0; ``num_processes`` the world size; ``process_id`` this
    process's rank.  ``local_device_ids`` names this process's cards
    (default: card ``process_id`` when NCCL is chosen).  ``backend``:
    ``"nccl"``, ``"gloo"`` or ``None`` (NCCL when each process has a card
    of its own).  A no-op if already initialized."""
    if is_initialized():
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("pass coordinator_address, num_processes and "
                         "process_id: nothing here detects a cluster")
    chosen = backend or _pick_backend(num_processes)
    if chosen == "nccl":
        card = (local_device_ids[0] if local_device_ids is not None
                else process_id)
        torch.cuda.set_device(card)
    print(f"audioflux_torch.parallel.distributed: backend {chosen} "
          f"({'named by the caller' if backend else 'chosen'}), process "
          f"{process_id} of {num_processes}", flush=True)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(chosen, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    process_barrier("af_init")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def backend() -> str | None:
    """The process group's backend, or None outside one."""
    return dist.get_backend() if is_initialized() else None


def process_barrier(name: str = "af_barrier", timeout_s: int = 120):
    """Block until every process reaches this point (``name`` is kept for
    the JAX signature)."""
    if not is_initialized() or dist.get_world_size() <= 1:
        return
    dist.barrier()


def global_from_local(local, mesh: Mesh, spec=("data", "time"),
                      keep_sharded: bool = False):
    """This process's block of the global array, as float32 on the mesh's
    first device; the sharded functions place its pieces on the mesh's
    devices.  ``spec`` names the mesh axis (or a tuple of axes) of each
    leading dimension (JAX's ``PartitionSpec``); a sharded dimension must
    divide its axis, the checks the JAX package's sharding makes.

    ``keep_sharded=True``: a ``ShardedTensor`` with ``spec`` (JAX's
    ``device_put`` with a ``NamedSharding``), each block placed straight
    from ``local`` on its mesh device; a block that the spec replicates
    over an axis is placed once, on that axis's first device."""
    if keep_sharded:
        return _placed(local, mesh, spec)
    local = place(local, mesh.first)
    for dim, axis in enumerate(tuple(spec)):
        if axis is None:
            continue
        if axis not in mesh.shape:
            raise ValueError(f"spec names axis {axis!r}, mesh has "
                             f"{mesh.axis_names}")
        if local.shape[dim] % mesh.shape[axis]:
            raise ValueError(f"dimension {dim} ({local.shape[dim]}) must "
                             f"divide mesh axis {axis!r} "
                             f"({mesh.shape[axis]})")
    return local


def _placed(local, mesh: Mesh, spec):
    if not isinstance(local, torch.Tensor):
        local = torch.from_numpy(np.ascontiguousarray(local, np.float32))
    for dim, axis in enumerate(tuple(spec)):
        if axis is None:
            continue
        axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        size = 1
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"spec names axis {a!r}, mesh has "
                                 f"{mesh.axis_names}")
            size *= mesh.shape[a]
        if local.shape[dim] % size:
            raise ValueError(f"dimension {dim} ({local.shape[dim]}) must "
                             f"divide mesh axis {axis!r} ({size})")
    out = Shards(mesh, spec)
    for pos, index in spec_layout(mesh, spec, tuple(local.shape)):
        out.put(place(local[index], mesh.devices[pos]), index,
                tuple(local.shape), pos)
    return out.out


def process_allgather(x, tiled: bool = True):
    """Every process's ``x`` (same shape in each), in rank order:
    concatenated along axis 0 with ``tiled``, else stacked on a new
    axis 0.  On the device ``x`` lies on; a gloo gather goes through the
    host.  Outside a process group it returns ``x``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    if not is_initialized() or dist.get_world_size() <= 1:
        return x if tiled else x[None]
    dev = x.device
    via_host = dist.get_backend() == "gloo"
    src = x.detach().cpu() if via_host else x.detach()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src.contiguous())
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return out.to(dev)
