"""Data parallelism across ranks (counterpart of
``mode_diffusion_policy_tpu/parallel/mesh.py``).

The JAX package shards each batch over a ``dp`` mesh axis and lets GSPMD
insert the collectives. Here one process per rank (``torchrun``) holds a
``torch.distributed`` process group, and a ``Mesh`` describes the world:

- parameters and BatchNorm statistics are replicated (``replicate``: a
  broadcast from rank 0);
- each rank takes its rows of every global batch (``shard_batch``,
  ``per_rank_batch``), and every statistic JAX takes over the batch is
  reduced across ranks inside the forward pass (``parallel/collectives``);
- the random draws of a step are made at the global batch's shape from a
  generator all ranks hold in the same state, and each rank keeps its rows
  (``draw_rows`` while ``data_parallel(mesh)`` is open), so a run of N
  ranks draws what one rank at the same global batch draws;
- ``zero1_ranges``: each rank's contiguous 1/N range of a flat buffer, for
  the ZeRO-1 optimizer state (``training/optim.ShardedFlats``).

A world of 1 (no process group) is the single-card path, unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# the torchrun variables init_distributed reads
ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world of one data-parallel run, seen from one rank: ``size``
    ranks, this one's ``rank`` (``local_rank`` of ``local_size`` on its
    host), its ``device``, the ``group`` of the collectives (None: the
    default group) and ``host_group``, a gloo group for the flags the host
    reduces (a CPU collective: it does not wait for the card)."""

    size: int = 1
    rank: int = 0
    local_rank: int = 0
    local_size: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None
    host_group: Any = None

    @property
    def backend(self) -> Optional[str]:
        """The process group's backend (None without one)."""
        if not (dist.is_available() and dist.is_initialized()):
            return None
        return dist.get_backend(self.group)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def _env_int(name: str, default: Optional[int] = None) -> int:
    v = os.environ.get(name)
    if v is None:
        if default is None:
            raise RuntimeError(f"init_distributed: {name} is not set (run "
                               "under torchrun, or set the torchrun "
                               f"variables {', '.join(ENV_KEYS)})")
        return default
    return int(v)


def init_distributed(backend: Optional[str] = None,
                     device=None) -> Mesh:
    """Start the process group from ``torchrun``'s environment and return
    the world's ``Mesh``. ``device`` defaults to ``cuda:<local rank>`` and
    raises without CUDA, as every entry point: the CPU only when named
    (``device="cpu"``). ``backend`` defaults to NCCL on CUDA and gloo on
    the CPU; gloo on CUDA is taken only when named (several ranks on one
    card). NCCL raises when it would put two ranks on one card."""
    rank, size = _env_int("RANK"), _env_int("WORLD_SIZE")
    local_rank = _env_int("LOCAL_RANK", rank)
    local_size = _env_int("LOCAL_WORLD_SIZE", size)
    device = resolve_device(device if device is not None
                            else torch.device("cuda", local_rank))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_size > n:
            raise RuntimeError(
                f"NCCL would put {local_size} ranks on {n} card(s): it "
                "takes one card per rank (name backend='gloo' to share a "
                "card)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        raise RuntimeError("init_distributed: a process group is already "
                           "up")
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=size)
    host = dist.new_group(backend="gloo") if backend != "gloo" else None
    global _HOST_GROUP
    _HOST_GROUP = host
    return make_mesh(device)


_HOST_GROUP = None


def make_mesh(device=None) -> Mesh:
    """The initialized world (``init_distributed``), or a world of 1 on
    ``device`` when no process group is up. ``device`` defaults to CUDA
    (``cuda:<local rank>`` in a group) and raises without it, as every
    entry point: the CPU only when named."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(device=resolve_device(device or "cuda"))
    size, rank = dist.get_world_size(), dist.get_rank()
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    device = resolve_device(device if device is not None
                            else torch.device("cuda", local_rank))
    return Mesh(size, rank, local_rank, local_size, device, None,
                _HOST_GROUP)


def destroy_distributed():
    """Tear the process group down (idempotent)."""
    global _HOST_GROUP
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def global_batch_size(per_rank_batch: int, mesh: Mesh) -> int:
    """The global batch of ``per_rank_batch`` rows on each rank."""
    return per_rank_batch * mesh.size


def per_rank_batch(batch_size: int, mesh: Mesh) -> int:
    """The rows each rank takes of a host's ``batch_size``: the config's
    batch is what one host feeds its local ranks per step (the JAX
    meaning: its local devices), so each rank takes ``batch_size /
    local_size``; raises where that does not divide, as JAX's batch
    sharding does."""
    if batch_size % mesh.local_size:
        raise ValueError(f"batch_size {batch_size} does not divide over "
                         f"{mesh.local_size} local ranks")
    return batch_size // mesh.local_size


def batch_sharding(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of a global batch of ``n_rows``: an equal,
    contiguous share (raises where ``n_rows`` does not divide)."""
    if n_rows % mesh.size:
        raise ValueError(f"a batch of {n_rows} rows does not shard over "
                         f"{mesh.size} ranks")
    per = n_rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _to_device(x, device):
    t = torch.as_tensor(np.asarray(x)) if not isinstance(
        x, torch.Tensor) else x
    if t.device == torch.device(device):
        return t
    if torch.device(device).type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def shard_batch(batch: Dict[str, Any], where) -> Dict[str, torch.Tensor]:
    """A host batch (a dict of numpy arrays or tensors) on its way to the
    card: ``where`` a device copies it there (CPU tensors pinned first, so
    the copy does not block); ``where`` a ``Mesh`` takes this rank's rows
    of a global batch (``batch_sharding``) to the mesh's device."""
    if isinstance(where, Mesh):
        out = {}
        for k, v in batch.items():
            sl = batch_sharding(where, len(v))
            out[k] = _to_device(v[sl] if isinstance(v, torch.Tensor)
                                else np.asarray(v)[sl], where.device)
        return out
    return {k: _to_device(v, where) for k, v in batch.items()}


@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh):
    """Broadcast each tensor from rank 0, in place (no-op for a world of
    1); returns them."""
    if mesh.size > 1:
        for t in tensors:
            dist.broadcast(t, 0, group=mesh.group)
    return tensors


def process_local_slice(total: int) -> Tuple[int, int]:
    """[start, end) of ``total`` items owned by this process: the
    ``torch.distributed`` rank's share when a process group is up, else
    everything (rank 0 of 1)."""
    if dist.is_available() and dist.is_initialized():
        n_proc, pid = dist.get_world_size(), dist.get_rank()
    else:
        n_proc, pid = 1, 0
    per, extra = divmod(total, n_proc)
    start = pid * per + min(pid, extra)
    return start, start + per + (1 if pid < extra else 0)


def zero1_ranges(numel: int, mesh: Mesh) -> Tuple[int, int]:
    """(per, lo): the ZeRO-1 share of a flat buffer of ``numel`` elements.
    Each rank holds ``per = ceil(numel / size)`` elements from ``lo = rank
    * per``; the buffer it gathers into is ``per * size`` long (the tail
    past ``numel`` is padding). The counterpart of JAX's
    ``zero1_state_sharding``, which shards the moments and the EMA on
    ``dp``."""
    per = -(-numel // mesh.size)
    return per, mesh.rank * per


def all_gather_flat(out: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Gather every rank's ``per``-long share of ``out`` (``per * size``
    long, this rank's share in place at ``rank * per``) into all of
    ``out``."""
    if mesh.size == 1:
        return out
    per = out.numel() // mesh.size
    if out.is_cuda and dist.get_backend(mesh.group) == "gloo":
        # gloo's one-tensor gather is not sure to take CUDA tensors:
        # broadcast each share from its owner instead
        for r in range(mesh.size):
            dist.broadcast(out[r * per:(r + 1) * per], r, group=mesh.group)
        return out
    mine = out[mesh.rank * per:(mesh.rank + 1) * per]
    # newer torch names it all_gather_single (all_gather_into_tensor warns
    # there that it is deprecated); older torch has only the old name
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, mine.clone(), group=mesh.group)
    return out


# ---------------------------------------------------------------------------
# the step's world: reductions in the forward pass and global draws
# ---------------------------------------------------------------------------

_ACTIVE: Optional[Mesh] = None


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """While open (a train or validation step of a world of more than one
    rank), BatchNorm and the router's load balance reduce their batch
    statistics across ``mesh``, and ``draw_rows`` draws at the global
    batch's shape. A world of 1 opens nothing."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.size > 1 else None
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def active() -> Optional[Mesh]:
    """The mesh of the open ``data_parallel`` step (None: one rank)."""
    return _ACTIVE


_LAYOUT: Tuple[int, Any] = (0, None)


@contextlib.contextmanager
def batch_layout(dim: int = 0, rows=None):
    """Where the batch lies in the arrays of the draws made while open:
    on ``dim``, or as ``rows = (index, total)``, this rank's rows
    ``index`` of a global array of ``total`` rows (the expert-sorted pairs
    of ``ops/moe.moe_ffn_topk_grouped``). Read by ``draw_rows`` in a
    data-parallel step only."""
    global _LAYOUT
    prev = _LAYOUT
    _LAYOUT = (dim, rows)
    try:
        yield
    finally:
        _LAYOUT = prev


def draw_rows(draw: Callable, shape, **kw) -> torch.Tensor:
    """``draw(shape, **kw)`` for this rank's rows: inside a data-parallel
    step the draw is made at the global batch's shape (the batch axis,
    dim 0 or ``batch_layout``'s, times the world size) and this rank's
    block of it is returned, so every rank's generator advances alike and
    N ranks draw what one rank at the global batch draws; else
    ``draw(shape)``."""
    mesh = _ACTIVE
    shape = tuple(shape)
    if mesh is None:
        return draw(shape, **kw)
    dim, rows = _LAYOUT
    if rows is not None:
        index, total = rows
        return draw((total,) + shape[1:], **kw)[index]
    n = shape[dim]
    full = shape[:dim] + (n * mesh.size,) + shape[dim + 1:]
    return draw(full, **kw).narrow(dim, mesh.rank * n, n)


@torch.no_grad()
def host_all_min(values: Sequence[int], mesh: Mesh) -> list:
    """The elementwise minimum over ranks of a few host integers, on the
    host group (a CPU collective)."""
    t = torch.tensor(list(values), dtype=torch.int64)
    if mesh.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MIN,
                        group=mesh.host_group or mesh.group)
    return t.tolist()


def barrier(mesh: Mesh):
    if mesh.size > 1:
        dist.barrier(group=mesh.host_group or mesh.group)
