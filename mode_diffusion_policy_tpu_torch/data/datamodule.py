"""CALVIN data module: datasets -> this process's share of the examples, in
prefetched batches (counterpart of
``mode_diffusion_policy_tpu/data/datamodule.py``).

Replaces the reference HulcDataModule (hulc_data_module.py:23-160) with its
DataLoader workers and DistributedSampler: each process takes its slice of
the example indices (``parallel.mesh.process_local_slice``), shuffled by a
numpy generator seeded with ``seed + epoch``; a background thread
prefetches the batches; ``num_workers >= 1`` assembles them in that many
worker processes, started from ``forkserver``, never by a bare fork of a
parent that holds a CUDA context. Workers run numpy code
only and never touch the card. Language instructions are embedded in the
parent, through the ``LangEmbeddingCache`` on the card: ``lang_emb`` stays
a device tensor, which ``shard_batch`` passes through. Frames stay uint8
until the train step preprocesses them on the card.

The batch stream is the JAX package's bit for bit: the same shuffles, the
same chunks, the same collation, whatever the worker count.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..parallel.mesh import process_local_slice
from .calvin_dataset import ExtendedDiskDataset
from .episode_utils import load_dataset_statistics

logger = logging.getLogger(__name__)

SHM_KEYS = ("rgb_static", "rgb_gripper", "robot_obs", "scene_obs",
            "rel_actions")


def embed_texts(lang_embed: Callable, texts: List[str]):
    """``lang_embed(texts)`` as f32: a tensor stays where the embedder put
    it (the card, for the ``LangEmbeddingCache`` of a CUDA tower), anything
    else becomes a numpy array. The embedder may run on the prefetch
    thread: the calling thread waits here until the card has computed the
    embedding, so the train step never reads it unfinished."""
    emb = lang_embed(texts)
    if not isinstance(emb, torch.Tensor):
        return np.asarray(emb, np.float32)
    emb = emb.float()
    if emb.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(emb.device))
        done.synchronize()
    return emb


def collate_episodes(items: List[Dict],
                     lang_embed: Optional[Callable] = None) -> Dict[str, Any]:
    """Stack a list of dataset items into one batch dict with uint8 images.
    Output keys match MoDEAgent.training_loss expectations."""
    batch = {cam: np.stack([it["rgb_obs"][cam] for it in items])
             for cam in ("rgb_static", "rgb_gripper")}
    for key in ("actions", "robot_obs"):
        batch[key] = np.stack([it[key] for it in items]).astype(np.float32)
    batch["idx"] = np.asarray([it["idx"] for it in items], np.int64)
    texts = [str(it.get("lang_text", "")) for it in items]
    batch["lang_text"] = texts
    if lang_embed is not None:
        batch["lang_emb"] = embed_texts(lang_embed, texts)
    elif "lang" in items[0]:
        batch["lang_emb"] = np.stack(
            [np.asarray(it["lang"], np.float32).reshape(1, -1)
             for it in items])
    return batch


class _Prefetcher:
    """Background-thread batch prefetch (the stand-in for the reference's
    DataLoader prefetching)."""

    def __init__(self, gen_fn, depth: int = 2):
        self._gen_fn = gen_fn
        self._depth = depth

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        DONE = object()
        stop = threading.Event()

        def put(item):
            # a bounded put that gives up when the consumer abandons the
            # iterator: a plain q.put would block this thread forever and
            # keep the inner generator (and the worker processes it
            # manages) alive past interpreter shutdown, deadlocking
            # multiprocessing's atexit join
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            gen = self._gen_fn()
            try:
                for item in gen:
                    if not put(item):
                        return
                put(DONE)
            except BaseException as e:  # the training loop sees the loader
                put(e)                  # fail instead of a short epoch
            finally:
                gen.close()   # runs the inner finally (stops the workers)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=10)


def _pool_worker(dataset, wid, num_workers, chunks, q):
    """Assemble every batch with ``batch_idx % num_workers == wid`` in
    order and ship ``("batch", idx, batch)`` over this worker's own bounded
    queue. Runs in a forkserver child: numpy work only (the language
    embedder runs in the parent)."""
    try:
        for bi in range(wid, len(chunks), num_workers):
            items = [dataset[int(j)] for j in chunks[bi]]
            q.put(("batch", bi, collate_episodes(items, lang_embed=None)))
    except BaseException as e:  # surfaced by the parent as RuntimeError
        try:
            q.put(("error", wid, repr(e)))
        except Exception:
            pass


class _WorkerPool:
    """Batch assembly in worker processes over the (shared-memory backed)
    dataset: the counterpart of the reference's 12-worker DataLoaders
    (hulc_data_module.py:100-116, shared_memory_utils.py:174-186).

    The dataset is pickled to each child; shm segments re-attach by name
    (``SharedEpisodeCache.__setstate__``), so frames stay zero-copy.

    Order and memory: worker ``w`` owns batches ``w, w+W, w+2W, ...`` and
    its own queue bounded at ``QUEUE_DEPTH`` entries, and the parent reads
    queue ``bi % W`` for batch ``bi``: the stream equals the one-process
    stream with no reorder buffer, and a fast worker blocks after
    ``QUEUE_DEPTH`` undelivered batches. A worker that raises, exits early
    or cannot be started (an unpicklable dataset) raises ``RuntimeError``
    in the parent."""

    QUEUE_DEPTH = 2   # per-worker in-flight bound => parent holds <= 1 batch

    def __init__(self, dataset, indices, batch_size: int, num_workers: int,
                 drop_last: bool = True):
        self.dataset = dataset
        self.indices = indices
        self.bs = batch_size
        self.num_workers = num_workers
        self.drop_last = drop_last

    def _chunks(self):
        bs, idx = self.bs, self.indices
        out = []
        for i in range(0, len(idx), bs):
            c = idx[i:i + bs]
            if self.drop_last and len(c) < bs:
                break
            out.append(c)
        return out

    def __iter__(self):
        import multiprocessing as mp
        # not a bare fork, which would copy the parent's threads and CUDA
        # context; the fork server imports this module (numpy, torch) once,
        # so a worker forked from it starts without importing them again
        # (no effect once the server runs; the server never touches CUDA)
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])
        chunks = self._chunks()
        if not chunks:
            return
        W = min(self.num_workers, len(chunks))
        qs = [ctx.Queue(maxsize=self.QUEUE_DEPTH) for _ in range(W)]
        procs = []
        try:
            try:
                for w in range(W):
                    p = ctx.Process(target=_pool_worker,
                                    args=(self.dataset, w, W, chunks, qs[w]),
                                    daemon=True)
                    p.start()
                    procs.append(p)
            except Exception as e:
                # e.g. an unpicklable dataset
                raise RuntimeError(
                    f"loader worker failed to start: {e!r}") from e
            for bi in range(len(chunks)):
                q = qs[bi % W]
                while True:
                    try:
                        tag, wid, payload = q.get(timeout=0.5)
                        break
                    except queue.Empty:
                        if not procs[bi % W].is_alive():
                            try:   # the batch may have landed before exit
                                tag, wid, payload = q.get(timeout=0.5)
                                break
                            except queue.Empty:
                                raise RuntimeError(
                                    f"loader workers exited early: batch "
                                    f"{bi} of {len(chunks)} never arrived")
                if tag == "error":
                    raise RuntimeError(f"loader worker failed: {payload}")
                assert tag == "batch" and wid == bi, (tag, wid, bi)
                yield payload
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=5)
            for q in qs:
                q.close()


def stop_helper_processes() -> None:
    """Stop the fork server that starts the loader workers and
    multiprocessing's resource tracker (which the shm cache and the worker
    queues start), and wait until both have exited. Left alone, both live
    until this process ends and exit a moment after it, the fork server
    while it tears down its own torch; a program that must leave no
    process behind calls this last. The tracker unlinks every segment
    still registered with it as it stops, so call it only once the shm
    caches are closed. Does nothing for a helper that is not running; the
    next loader starts them again."""
    from multiprocessing import forkserver, resource_tracker
    # the tracker's pipe stays open until the fork server has exited
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


class CalvinDataModule:
    """Builds train/val ExtendedDiskDatasets and batch iterators
    (reference HulcDataModule.setup/train_dataloader,
    hulc_data_module.py:77-160). ``num_workers >= 1`` starts that many batch
    assembly processes (see :class:`_WorkerPool`); 0 assembles inline under
    the prefetch thread.

    ``use_shm_cache`` packs each split's frames into shared memory at
    ``setup`` under the tag ``{shm_tag}_{split}`` (by default
    ``calvin{pid}``, so concurrent runs on one machine do not collide);
    ``close`` unlinks them (an exit or SIGTERM does too)."""

    def __init__(self, root_data_dir: str, *, batch_size: int = 32,
                 act_seq_len: int = 10, obs_seq_len: int = 1,
                 lang_folder: str = "lang_annotations",
                 use_extracted_rel_actions: bool = False,
                 use_shm_cache: bool = False,
                 lang_embed: Optional[Callable] = None,
                 shuffle_val: bool = False, seed: int = 42,
                 transforms: Optional[Dict] = None,
                 dataset_cls=ExtendedDiskDataset,
                 dataset_kwargs: Optional[Dict] = None,
                 num_workers: int = 0, shm_tag: Optional[str] = None):
        self.root = Path(root_data_dir)
        self.training_dir = self.root / "training"
        self.val_dir = self.root / "validation"
        self.batch_size = batch_size
        self.act_seq_len = act_seq_len
        self.obs_seq_len = obs_seq_len
        self.lang_folder = lang_folder
        self.use_extracted_rel_actions = use_extracted_rel_actions
        self.use_shm_cache = use_shm_cache
        self.shm_tag = shm_tag or f"calvin{os.getpid()}"
        self._shm_caches = []
        self.lang_embed = lang_embed
        self.shuffle_val = shuffle_val
        self.seed = seed
        self.dataset_cls = dataset_cls
        self.dataset_kwargs = dataset_kwargs or {}
        self.num_workers = num_workers
        self.transforms = transforms or {"train": {}, "val": {}}
        self.train_dataset = None
        self.val_dataset = None

    def setup(self):
        self.transforms = load_dataset_statistics(
            self.training_dir, self.val_dir, self.transforms)
        common = dict(
            key="lang", lang_folder=self.lang_folder,
            batch_size=self.batch_size,
            min_window_size=self.act_seq_len,
            max_window_size=self.act_seq_len, pad=False,
            aux_lang_loss_window=8,
            obs_seq_len=self.obs_seq_len, action_seq_len=self.act_seq_len,
            future_range=1,
            use_extracted_rel_actions=self.use_extracted_rel_actions,
            **self.dataset_kwargs)
        shm = {"training": None, "validation": None}
        if self.use_shm_cache:
            # preload the frames into POSIX shared memory once (the
            # reference's SharedMemoryLoader): no npz read per item
            from .shm_cache import SharedEpisodeCache
            for split, d in (("training", self.training_dir),
                             ("validation", self.val_dir)):
                cache = SharedEpisodeCache.build(
                    d, keys=list(SHM_KEYS), tag=f"{self.shm_tag}_{split}")
                shm[split] = cache
                self._shm_caches.append(cache)
        self.train_dataset = self.dataset_cls(
            self.training_dir, shm_cache=shm["training"], **common)
        self.val_dataset = self.dataset_cls(
            self.val_dir, shm_cache=shm["validation"], **common)
        logger.info("train examples: %d, val examples: %d",
                    len(self.train_dataset), len(self.val_dataset))
        return self

    def close(self):
        """Unlink the shared-memory caches (idempotent)."""
        for cache in self._shm_caches:
            cache.cleanup()
        self._shm_caches.clear()

    def _iter_batches(self, dataset, shuffle: bool, epoch_seed: int,
                      drop_last: bool = True) -> Iterator[Dict]:
        n = len(dataset)
        start, end = process_local_slice(n)
        indices = np.arange(start, end)
        if shuffle:
            np.random.default_rng(self.seed + epoch_seed).shuffle(indices)
        bs = self.batch_size
        if self.num_workers >= 1:
            # worker-pool assembly; the language embedder (on the card)
            # runs here in the parent, never in a child
            for batch in _WorkerPool(dataset, indices, bs, self.num_workers,
                                     drop_last):
                if self.lang_embed is not None:
                    batch["lang_emb"] = embed_texts(self.lang_embed,
                                                    batch["lang_text"])
                yield batch
            return
        for i in range(0, len(indices) - (bs - 1 if drop_last else 0), bs):
            chunk = indices[i:i + bs]
            if drop_last and len(chunk) < bs:
                return
            items = [dataset[int(j)] for j in chunk]
            yield collate_episodes(items, self.lang_embed)

    def train_batches(self, epoch: int = 0) -> Iterator[Dict]:
        return iter(_Prefetcher(
            lambda: self._iter_batches(self.train_dataset, True, epoch)))

    def val_batches(self, epoch: int = 0) -> Iterator[Dict]:
        return iter(_Prefetcher(
            lambda: self._iter_batches(self.val_dataset, self.shuffle_val,
                                       epoch)))
