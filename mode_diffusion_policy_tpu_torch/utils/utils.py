"""Small utilities (counterpart of ``mode_diffusion_policy_tpu/utils/utils.py``)."""
from __future__ import annotations

import logging
import subprocess
import sys
from pathlib import Path

import torch


def get_git_commit_hash(repo_path=None) -> str:
    """The checkout's HEAD commit, or "unknown"."""
    try:
        repo_path = repo_path or Path(__file__).resolve().parents[2]
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], cwd=repo_path,
            stderr=subprocess.DEVNULL).decode().strip()
    except Exception:
        return "unknown"


def log_environment_info(logger: logging.Logger, device=None):
    """Python and torch versions, the device and the git commit
    (the reference's utils.py:92-137)."""
    logger.info("python %s", sys.version.split()[0])
    logger.info("torch %s, CUDA %s", torch.__version__, torch.version.cuda)
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        logger.info("device: %s (%d visible)",
                    torch.cuda.get_device_name(dev),
                    torch.cuda.device_count())
    else:
        logger.info("device: %s", dev or "cpu")
    logger.info("git commit: %s", get_git_commit_hash())


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
