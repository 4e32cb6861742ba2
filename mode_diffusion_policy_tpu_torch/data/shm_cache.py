"""Shared-memory episode cache (counterpart of
``mode_diffusion_policy_tpu/data/shm_cache.py``; copied, with names of its
own).

Preloads chosen keys of every ``episode_*.npz`` of a split into POSIX
shared memory once, then serves zero-copy numpy views to every loader
process: one segment per key holding the packed frames, an offset lookup
persisted beside it so sibling processes can attach, and atexit/SIGTERM
unlink handlers (a redesign of the reference's SharedMemoryLoader,
``datasets/utils/shared_memory_utils.py:61-324``).

Segments are named ``mode_torch_{tag}_{key}`` and the lookup file
``mode_torch_{tag}_shm_lookup.npy`` in the temporary directory
(``tempfile.gettempdir()``): the JAX package's ``mode_tpu_`` segments and
``/tmp/{tag}_shm_lookup.npy`` files never collide with them, even for the
same tag. ``build`` replaces a live segment of the same name, so two
processes must not build one tag at once.
"""
from __future__ import annotations

import atexit
import logging
import os
import signal
import tempfile
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import shared_memory
from typing import Dict, Sequence

import numpy as np

logger = logging.getLogger(__name__)

SEGMENT_PREFIX = "mode_torch_"


def segment_name(tag: str, key: str) -> str:
    return f"{SEGMENT_PREFIX}{tag}_{key}"


def lookup_path(tag: str) -> str:
    return os.path.join(tempfile.gettempdir(),
                        f"{SEGMENT_PREFIX}{tag}_shm_lookup.npy")


class SharedEpisodeCache:
    """Pack selected keys of every episode_*.npz into shared memory."""

    def __init__(self, tag: str):
        self.tag = tag
        self._segments: Dict[str, shared_memory.SharedMemory] = {}
        self.lookup: Dict = {}
        self._owner = False

    # -- building ---------------------------------------------------------
    @classmethod
    def build(cls, dataset_dir, keys: Sequence[str], tag: str,
              workers: int = 8) -> "SharedEpisodeCache":
        from .preprocess import list_episode_files
        self = cls(tag)
        self._owner = True
        files = list_episode_files(str(dataset_dir))
        if not files:
            raise FileNotFoundError(f"no episodes under {dataset_dir}")

        def load(item):
            _, path = item
            with np.load(path, allow_pickle=True) as d:
                return {k: np.asarray(d[k]) for k in keys}

        with ThreadPoolExecutor(max_workers=workers) as pool:
            episodes = list(pool.map(load, files))

        self.lookup = {"episode_ids": [idx for idx, _ in files], "keys": {}}
        self._install_cleanup()
        for key in keys:
            arrs = [ep[key] for ep in episodes]
            shape = (len(arrs),) + arrs[0].shape
            dtype = arrs[0].dtype
            nbytes = int(np.prod(shape)) * dtype.itemsize
            seg_name = segment_name(tag, key)
            try:
                seg = shared_memory.SharedMemory(name=seg_name, create=True,
                                                 size=nbytes)
            except FileExistsError:
                old = shared_memory.SharedMemory(name=seg_name)
                old.close()
                old.unlink()
                seg = shared_memory.SharedMemory(name=seg_name, create=True,
                                                 size=nbytes)
            self._segments[key] = seg
            view = np.ndarray(shape, dtype=dtype, buffer=seg.buf)
            for i, a in enumerate(arrs):
                view[i] = a
            del view
            self.lookup["keys"][key] = {"segment": seg_name, "shape": shape,
                                        "dtype": str(dtype)}
        np.save(lookup_path(tag), np.asarray(self.lookup, dtype=object),
                allow_pickle=True)
        logger.info("shm cache '%s': %d episodes, keys=%s", tag, len(files),
                    list(keys))
        return self

    # -- attaching (sibling processes) ------------------------------------
    @classmethod
    def attach(cls, tag: str) -> "SharedEpisodeCache":
        self = cls(tag)
        self.lookup = np.load(lookup_path(tag), allow_pickle=True).item()
        self._attach_segments()
        return self

    def _attach_segments(self):
        for key, meta in self.lookup["keys"].items():
            self._segments[key] = shared_memory.SharedMemory(
                name=meta["segment"])

    # -- pickling (forkserver loader workers) -------------------------------
    def __getstate__(self):
        # workers re-attach by segment name; SharedMemory handles and the
        # unlink duty (ownership) never cross process boundaries
        return {"tag": self.tag, "lookup": self.lookup}

    def __setstate__(self, state):
        self.tag = state["tag"]
        self.lookup = state["lookup"]
        self._owner = False
        self._segments = {}
        self._attach_segments()

    # -- access -----------------------------------------------------------
    def array(self, key: str) -> np.ndarray:
        meta = self.lookup["keys"][key]
        return np.ndarray(tuple(meta["shape"]), dtype=np.dtype(meta["dtype"]),
                          buffer=self._segments[key].buf)

    def episode(self, episode_id: int, key: str) -> np.ndarray:
        if not hasattr(self, "_id_to_idx"):
            self._id_to_idx = {int(e): i for i, e in
                               enumerate(self.lookup["episode_ids"])}
        return self.array(key)[self._id_to_idx[int(episode_id)]]

    def __contains__(self, key: str) -> bool:
        return key in self.lookup.get("keys", {})

    # -- cleanup (shared_memory_utils.py:264,311-324) ----------------------
    def _install_cleanup(self):
        atexit.register(self.cleanup)
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self.cleanup()
            if callable(prev):
                prev(signum, frame)
            else:
                raise SystemExit(0)

        try:
            signal.signal(signal.SIGTERM, handler)
            self._sigterm = (handler, prev)
        except ValueError:
            pass  # not the main thread

    def cleanup(self):
        """Close this process's handles; the owner also unlinks the segments
        and the lookup file, and takes its exit handlers back (the SIGTERM
        handler only while it is still the installed one). Idempotent."""
        sigterm = self.__dict__.pop("_sigterm", None)
        if sigterm is not None:
            atexit.unregister(self.cleanup)
            try:
                if signal.getsignal(signal.SIGTERM) is sigterm[0]:
                    signal.signal(signal.SIGTERM, sigterm[1]
                                  if sigterm[1] is not None
                                  else signal.SIG_DFL)
            except ValueError:
                pass  # not the main thread
        for seg in self._segments.values():
            if self._owner:
                try:
                    seg.unlink()
                except FileNotFoundError:
                    pass
            try:
                seg.close()
            except BufferError:
                pass  # a live view still maps it; the unlink above stands
        self._segments.clear()
        if self._owner:
            try:
                os.unlink(lookup_path(self.tag))
            except FileNotFoundError:
                pass
