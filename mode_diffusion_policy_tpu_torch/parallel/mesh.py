"""Batch placement and the host's share of the data (counterpart of
``shard_batch`` and ``process_local_slice`` in
``mode_diffusion_policy_tpu/parallel/mesh.py``), for one card.

The JAX package shards a batch over a device mesh; here a batch goes to the
one card as a non-blocking copy. Data parallelism across cards (DDP with
SyncBatchNorm, and the ZeRO-1 state sharding) is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def shard_batch(batch, device):
    """Copy a host batch (a dict of numpy arrays or tensors) to ``device``:
    CPU tensors are pinned first, so the copy to a card does not block."""
    def put(x):
        t = torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x
        if t.device == torch.device(device):
            return t
        if torch.device(device).type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return {k: put(v) for k, v in batch.items()}


def process_local_slice(total: int) -> Tuple[int, int]:
    """[start, end) of ``total`` items owned by this process: the
    ``torch.distributed`` rank's share when a process group is up, else
    everything (rank 0 of 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        n_proc, pid = dist.get_world_size(), dist.get_rank()
    else:
        n_proc, pid = 1, 0
    per, extra = divmod(total, n_proc)
    start = pid * per + min(pid, extra)
    return start, start + per + (1 if pid < extra else 0)
