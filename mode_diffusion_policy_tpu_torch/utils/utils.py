"""Small utilities (counterpart of ``mode_diffusion_policy_tpu/utils/utils.py``)."""
from __future__ import annotations

import torch


def device_memory_stats(device=None) -> dict:
    """Memory of a CUDA device from ``torch.cuda.memory_stats`` (the
    caching allocator's bytes in use and their peak) and its capacity, in
    GiB, under the JAX package's metric names; {} for the CPU."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") or \
            not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    gib = 1024 ** 3
    return {
        "mem/bytes_in_use_gib": stats.get("allocated_bytes.all.current", 0)
        / gib,
        "mem/peak_bytes_in_use_gib": stats.get("allocated_bytes.all.peak", 0)
        / gib,
        "mem/bytes_limit_gib": torch.cuda.mem_get_info(dev)[1] / gib,
    }
