"""Thread-safe LRU cache of language-goal embeddings (counterpart of
``mode_diffusion_policy_tpu/models/encoders/lang_cache.py``).

Instruction text -> embedding, encoding only the misses of a batch, with
save/load. The embeddings stay on the encoder's device (the JAX cache keeps
numpy arrays on the host): a hit costs no copy to the card, and the values
are the same. The saved file is the JAX cache's format (a pickled dict of
numpy arrays), so either package reads the other's.

``VLMEmbeddingCache`` keeps per-token embeddings of varying length, for
encoders that return one [L_i, D] row block per text, and hands a batch
out zero-padded with its attention mask.
"""
from __future__ import annotations

import pickle
import threading
from collections import OrderedDict
from typing import Callable, List, Optional, Sequence

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
        return torch.stack(self._lookup(texts))

    def _lookup(self, texts) -> List[torch.Tensor]:
        """The cached value of each text (a str is one text), encoding the
        misses once each, in one encoder call."""
        if isinstance(texts, str):
            texts = [texts]
        texts = list(texts)
        with self._lock:
            misses = [t for t in dict.fromkeys(texts) if t not in self._buf]
        if misses:
            encoded = [torch.as_tensor(e, device=self.device)
                       for e in self.encoder(misses)]
            with self._lock:
                self.encoder_calls += 1
                self.encoded_texts += len(misses)
                for t, e in zip(misses, encoded):
                    self._put(t, e)
        with self._lock:
            return [self._get(t) for t in texts]

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


class VLMEmbeddingCache(LangEmbeddingCache):
    """Per-token embeddings of varying length, with padding and attention
    masks (the reference ``VLMEmbeddingBuffer``): for encoders that return
    one [L_i, D] embedding per text (``encoder(texts) -> sequence of
    [L_i, D]``) rather than one pooled vector. A batch comes out padded to
    ``max_length`` tokens (longer ones cut), on the cache's device."""

    def __init__(self, encoder, buffer_size: int = 10000,
                 max_length: int = 77, pad_token_id: int = 0, device=None):
        super().__init__(encoder, buffer_size, device)
        self.max_length = max_length
        self.pad_token_id = pad_token_id

    @staticmethod
    def pad_sequences(sequences: Sequence[torch.Tensor],
                      max_len: Optional[int] = None):
        """Zero-pad [L_i, D] tensors to a common length (the longest, or
        ``max_len``, cutting longer ones): (padded [N, L, D] in the first
        one's dtype and device, attention mask [N, L] f32, 1 on tokens)."""
        sequences = [torch.as_tensor(s) for s in sequences]
        if max_len is None:
            max_len = max(s.shape[0] for s in sequences)
        first = sequences[0]
        padded = torch.zeros((len(sequences), max_len, first.shape[-1]),
                             dtype=first.dtype, device=first.device)
        mask = torch.zeros((len(sequences), max_len), dtype=torch.float32,
                           device=first.device)
        for i, s in enumerate(sequences):
            L = min(s.shape[0], max_len)
            padded[i, :L] = s[:L]
            mask[i, :L] = 1.0
        return padded, mask

    def get_goal_instruction_embeddings(self, texts):
        """[N, max_length, D] padded embeddings and the [N, max_length]
        mask, encoding only the texts not already cached."""
        return self.pad_sequences(self._lookup(texts), self.max_length)

    __call__ = get_goal_instruction_embeddings
