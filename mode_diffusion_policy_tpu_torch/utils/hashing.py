"""pyhash-compatible FNV hashers, in pure Python (counterpart of
``mode_diffusion_policy_tpu/utils/hashing.py``).

CALVIN's evaluation seeds every scene reset with FNV-1 32 of the initial
condition's text (``evaluation/utils.get_env_state_for_initial_condition``),
so the hashes must be pyhash's bit for bit:

- a hasher is constructed per algorithm and then called:
  ``hasher = fnv1_32(); hasher("5")``;
- the default seed is 0, not the canonical FNV offset basis (a pyhash
  quirk);
- a ``str`` is hashed as its UTF-16LE encoding without a BOM, bytes and
  buffers raw;
- several arguments chain: each one's hash is the next one's seed.

Only the FNV family is here: the evaluation path hashes one short string
per chain, and the CALVIN datasets one index per validation window
(``get_validation_window_size``). The JAX package's native extension (the
other pyhash algorithms) is not ported (ROADMAP.md Queue 1).
"""
from __future__ import annotations

from typing import Union

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def _data(obj: Union[str, bytes, bytearray, memoryview]) -> bytes:
    if isinstance(obj, str):
        return obj.encode("utf-16-le")
    if isinstance(obj, bytes):
        return obj
    return bytes(obj)


class _Hasher:
    """pyhash call semantics over a per-algorithm ``_hash(buf, value)``."""

    _is64 = False

    def __init__(self, seed: int = 0):
        self.seed = seed

    def _hash(self, buf: bytes, value: int) -> int:
        raise NotImplementedError

    def __call__(self, *args, seed: int | None = None) -> int:
        value = self.seed if seed is None else seed
        for arg in args:
            value = self._hash(_data(arg), value)
        return value & (_MASK64 if self._is64 else _MASK32)


class fnv1_32(_Hasher):
    def _hash(self, buf, h):
        for b in buf:
            h = ((h * 16777619) & _MASK32) ^ b
        return h


class fnv1a_32(_Hasher):
    def _hash(self, buf, h):
        for b in buf:
            h = ((h ^ b) * 16777619) & _MASK32
        return h


class fnv1_64(_Hasher):
    _is64 = True

    def _hash(self, buf, h):
        for b in buf:
            h = ((h * 1099511628211) & _MASK64) ^ b
        return h


class fnv1a_64(_Hasher):
    _is64 = True

    def _hash(self, buf, h):
        for b in buf:
            h = ((h ^ b) * 1099511628211) & _MASK64
        return h


def get_validation_window_size(idx: int, min_window_size: int,
                               max_window_size: int,
                               hasher=None) -> int:
    """Deterministic validation window size via FNV-1 32 of str(idx)
    (reference base_dataset.py:24-37)."""
    h = hasher or fnv1_32()
    window_range = max_window_size - min_window_size + 1
    return min_window_size + h(str(idx)) % window_range
