"""Small utilities (counterpart of ``mode_diffusion_policy_tpu/utils/utils.py``):
environment and git logging, device memory, timing, batch-portion
selection, text overlays and sftp paths."""
from __future__ import annotations

import logging
import subprocess
import sys
import time
from functools import wraps
from pathlib import Path

import numpy as np
import torch


def timeit(fn):
    """Decorator: log ``"<name> took <s>s"`` at DEBUG on the logger of
    ``fn``'s module after each call."""
    @wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        logging.getLogger(fn.__module__).debug(
            "%s took %.3fs", fn.__name__, time.time() - t0)
        return out
    return wrapper


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


def get_portion_of_batch_ids(percentage: float, batch_size: int) -> np.ndarray:
    """``int(batch_size * percentage)`` distinct batch indices, sorted,
    drawn by ``numpy.random.default_rng(0)`` (the same ids every call)."""
    num = int(batch_size * percentage)
    if num == 0:
        return np.array([], dtype=int)
    rng = np.random.default_rng(0)
    return np.sort(rng.choice(np.arange(batch_size), num, replace=False))


def add_text_overlay(img: np.ndarray, text: str,
                     color=(255, 255, 255)) -> np.ndarray:
    """Burn an instruction string into the bottom left of a frame (OpenCV,
    imported here: a served path never needs it)."""
    import cv2
    img = np.ascontiguousarray(img)
    h = img.shape[0]
    cv2.putText(img, text, (5, h - 8), cv2.FONT_HERSHEY_SIMPLEX,
                max(0.3, h / 500.0), color, 1, cv2.LINE_AA)
    return img


def format_sftp_path(path) -> Path:
    """An ``sftp://host/...`` path as the local path ``/...``; any other
    path unchanged, as a ``Path``."""
    path = str(path)
    if path.startswith("sftp://"):
        path = "/" + path.split("/", 3)[-1]
    return Path(path)
