"""Thread-safe LRU cache of language-goal embeddings (counterpart of
``mode_diffusion_policy_tpu/models/encoders/lang_cache.py``).

Instruction text -> embedding, encoding only the misses of a batch, with
save/load. The embeddings stay on the encoder's device (the JAX cache keeps
numpy arrays on the host): a hit costs no copy to the card, and the values
are the same. The saved file is the JAX cache's format (a pickled dict of
numpy arrays), so either package reads the other's.

``VLMEmbeddingCache`` (per-token embeddings with padding masks) has no
caller on the ported paths yet (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import pickle
import threading
from collections import OrderedDict
from typing import Callable, List

import numpy as np
import torch


class LangEmbeddingCache:
    def __init__(self, encoder: Callable[[List[str]], torch.Tensor],
                 buffer_size: int = 10000, device=None):
        """encoder: list[str] -> [B, 1, D] embeddings (e.g. ``LangClip``);
        ``device`` where the embeddings live, by default the encoder's
        (``encoder.device``), else the CPU."""
        self.encoder = encoder
        self.buffer_size = buffer_size
        self.device = torch.device(device if device is not None else
                                   getattr(encoder, "device", "cpu"))
        # how many times the encoder ran, and on how many texts
        self.encoder_calls = 0
        self.encoded_texts = 0
        self._buf: OrderedDict[str, torch.Tensor] = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._buf)

    def get_goal_instruction_embeddings(self, texts) -> torch.Tensor:
        """[B, 1, D] embeddings for a batch of instructions, encoding only
        the texts not already cached (each distinct text once)."""
        if isinstance(texts, str):
            texts = [texts]
        texts = list(texts)
        with self._lock:
            misses = [t for t in dict.fromkeys(texts) if t not in self._buf]
        if misses:
            encoded = torch.as_tensor(self.encoder(misses), device=self.device)
            with self._lock:
                self.encoder_calls += 1
                self.encoded_texts += len(misses)
                for t, e in zip(misses, encoded):
                    self._put(t, e)
        with self._lock:
            out = [self._get(t) for t in texts]
        return torch.stack(out)

    __call__ = get_goal_instruction_embeddings

    def _put(self, key: str, value: torch.Tensor):
        if key in self._buf:
            self._buf.move_to_end(key)
        self._buf[key] = value
        while len(self._buf) > self.buffer_size:
            self._buf.popitem(last=False)

    def _get(self, key: str) -> torch.Tensor:
        self._buf.move_to_end(key)
        return self._buf[key]

    def save(self, path: str):
        with self._lock:
            data = {k: v.cpu().numpy() for k, v in self._buf.items()}
        with open(path, "wb") as f:
            pickle.dump(data, f)

    def load(self, path: str):
        """Read a saved cache (this one's or the JAX cache's file; pickle:
        load only files this program wrote)."""
        with open(path, "rb") as f:
            data = pickle.load(f)
        with self._lock:
            for k, v in data.items():
                self._put(k, torch.as_tensor(np.asarray(v),
                                             device=self.device))
