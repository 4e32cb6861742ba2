"""pyhash-compatible hashers (counterpart of
``mode_diffusion_policy_tpu/utils/hashing.py``).

CALVIN's evaluation seeds every scene reset with FNV-1 32 of the initial
condition's text (``evaluation/utils.get_env_state_for_initial_condition``),
and the datasets size their validation windows with it
(``get_validation_window_size``), so the hashes must be pyhash's bit for
bit. pyhash's call semantics, for every hasher here:

- a hasher is constructed per algorithm and then called:
  ``hasher = fnv1_32(); hasher("5")``;
- the default seed is 0, not the canonical FNV offset basis (a pyhash
  quirk); ``hasher(data, seed=s)`` overrides the instance's seed;
- a ``str`` is hashed as its UTF-16LE encoding without a BOM, ``bytes`` and
  other buffers raw; anything else raises ``TypeError``;
- several arguments chain: each one's hash, narrowed to the seed's width,
  is the next one's seed;
- 128- and 256-bit values are Python ints; the fingerprinters
  (``farm_fingerprint_*``, ``city_fingerprint_256``) take no seed and
  return one value per argument (a list for several).

The FNV family, which the datasets and the evaluation use, is pure Python.
Every other name of the pyhash surface runs the C source
``native/pyhashx.c`` through ``ctypes``: it is compiled with ``cc -O2
-shared -fPIC`` at the first construction of such a hasher, into
``<repo>/build/torch_native/`` (listed in ``.gitignore``) under a name that
carries a hash of the source and the flags. If the build fails, those
hashers raise on construction; there is no quiet substitute.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Union

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF

NATIVE_SRC = Path(__file__).resolve().parents[1] / "native" / "pyhashx.c"
BUILD_DIR = NATIVE_SRC.parents[2] / "build" / "torch_native"
CC_FLAGS = ("-O2", "-shared", "-fPIC")


def _data(obj: Union[str, bytes, bytearray, memoryview]) -> bytes:
    if isinstance(obj, str):
        return obj.encode("utf-16-le")
    if isinstance(obj, bytes):
        return obj
    try:
        return memoryview(obj).tobytes()
    except TypeError:
        raise TypeError(f"cannot hash object of type "
                        f"{type(obj).__name__}") from None


class _Hasher:
    """pyhash call semantics over a per-algorithm ``_hash(buf, value)``."""

    _is64 = False

    def __init__(self, seed: int = 0):
        self.seed = seed & (_MASK64 if self._is64 else _MASK32)

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


# ---------------------------------------------------------------------------
# The C hashers
# ---------------------------------------------------------------------------

def library_path(build_dir: Optional[Path] = None) -> Path:
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    h.update(NATIVE_SRC.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libpyhashx_{h.hexdigest()[:16]}.so"


def build_native(build_dir: Optional[Path] = None) -> Path:
    """Compile ``native/pyhashx.c`` into ``build_dir`` (default
    ``BUILD_DIR``) unless its library for the current source exists;
    returns the library's path. Raises RuntimeError when no C compiler is
    found or the build fails."""
    lib = library_path(build_dir)
    if lib.exists():
        return lib
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler (cc) found: the pyhash hashers "
                           "other than the FNV family are built from "
                           f"{NATIVE_SRC} at first use")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(NATIVE_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {NATIVE_SRC.name} failed "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


class _Native:
    """The loaded library and its table of hashers (name -> (algo id,
    value bits, seed bits; 0 seed bits: a fingerprinter))."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        self.lib.pyhashx_init.argtypes = []
        self.lib.pyhashx_init.restype = None
        self.lib.pyhashx_spec.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)] + [
            ctypes.POINTER(ctypes.c_int)] * 3
        self.lib.pyhashx_spec.restype = ctypes.c_int
        self.lib.pyhashx_hash.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
        self.lib.pyhashx_hash.restype = None
        self.lib.pyhashx_init()
        self.specs = {}
        name = ctypes.c_char_p()
        algo, vbits, sbits = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        i = 0
        while self.lib.pyhashx_spec(i, ctypes.byref(name), ctypes.byref(algo),
                                    ctypes.byref(vbits), ctypes.byref(sbits)):
            self.specs[name.value.decode()] = (algo.value, vbits.value,
                                               sbits.value)
            i += 1

    def hash(self, algo: int, buf: bytes, seed_words) -> list:
        seed = (ctypes.c_uint64 * 4)(*seed_words)
        out = (ctypes.c_uint64 * 4)()
        self.lib.pyhashx_hash(algo, buf, len(buf), seed, out)
        return list(out)


_native: Optional[_Native] = None
_native_lock = threading.Lock()


def load_native(build_dir: Optional[Path] = None) -> _Native:
    """Build (``build_native``) and load the C hashers, once per process;
    ``build_dir`` matters only for the first call."""
    global _native
    with _native_lock:
        if _native is None:
            _native = _Native(build_native(build_dir))
        return _native


def _words(value: int, bits: int) -> list:
    """An int as 4 64-bit words, least significant first, cut to ``bits``
    (pyhash's conversion of a seed: masked, negative ints two's
    complement)."""
    if bits <= 64:
        w0 = value & _MASK64
        return [w0 & _MASK32 if bits == 32 else w0, 0, 0, 0]
    n = bits // 64
    return [(value >> (64 * i)) & _MASK64 if i < n else 0 for i in range(4)]


def _int(words, bits: int) -> int:
    if bits <= 32:
        return words[0] & _MASK32
    return sum(w << (64 * i) for i, w in enumerate(words[:max(1, bits // 64)]))


class _NativeHasher:
    """A pyhash hasher running the C algorithm of its name."""

    _name = ""

    def __init__(self, *args, **kwargs):
        self._lib = load_native()
        self._algo, self._vbits, self._sbits = self._lib.specs[self._name]
        if self._sbits == 0:
            if args or kwargs:
                raise TypeError(f"{self._name}() takes no seed")
            self._seed = [0, 0, 0, 0]
            return
        if len(args) + len(kwargs) > 1 or (kwargs and "seed" not in kwargs):
            raise TypeError(f"{self._name}() takes one argument, seed")
        self.seed = args[0] if args else kwargs.get("seed", 0)

    @property
    def seed(self) -> int:
        return _int(self._seed, self._sbits or 64)

    @seed.setter
    def seed(self, value: int):
        self._seed = _words(int(value), self._sbits or 64)

    def __call__(self, *args, seed: Optional[int] = None):
        if self._sbits == 0:
            if not args:
                raise TypeError("fingerprinter requires at least one "
                                "argument")
            out = [_int(self._lib.hash(self._algo, _data(a), [0] * 4),
                        self._vbits) for a in args]
            return out if len(args) > 1 else out[0]
        value = self._seed if seed is None else _words(int(seed),
                                                       self._vbits)
        for arg in args:
            # the value narrowed to the seed's width chains into the next
            narrow = [value[0] & _MASK32 if self._sbits == 32 else value[0],
                      value[1] if self._sbits == 128 else 0, 0, 0]
            value = self._lib.hash(self._algo, _data(arg), narrow)
        return _int(value, self._vbits)


NATIVE_NAMES = (
    "murmur1_32", "murmur1_aligned_32", "murmur2_32", "murmur2a_32",
    "murmur2_aligned_32", "murmur2_neutral_32", "murmur2_x64_64a",
    "murmur2_x86_64b", "murmur3_32", "murmur3_x86_128", "murmur3_x64_128",
    "lookup3_little", "lookup3_big", "lookup3", "super_fast_hash", "city_32",
    "city_64", "city_128", "city_crc_128", "city_fingerprint_256",
    "spooky_32", "spooky_64", "spooky_128", "farm_32", "farm_64", "farm_128",
    "farm_fingerprint_32", "farm_fingerprint_64", "farm_fingerprint_128",
    "metro_64_1", "metro_64_2", "metro_128_1", "metro_128_2",
    "metro_64_crc_1", "metro_64_crc_2", "metro_128_crc_1", "metro_128_crc_2",
    "mum_64", "t1ha2_atonce", "t1ha2_atonce128", "t1ha1_le", "t1ha1_be",
    "t1ha0", "t1ha", "xx_32", "xx_64")

for _n in NATIVE_NAMES:
    globals()[_n] = type(_n, (_NativeHasher,), {"_name": _n,
                                                "__module__": __name__})
del _n

# the pure-Python FNV hashers under the JAX package's fallback names
py_fnv1_32 = fnv1_32
py_fnv1a_32 = fnv1a_32
py_fnv1_64 = fnv1_64
py_fnv1a_64 = fnv1a_64


def get_validation_window_size(idx: int, min_window_size: int,
                               max_window_size: int,
                               hasher=None) -> int:
    """Deterministic validation window size via FNV-1 32 of str(idx)
    (reference base_dataset.py:24-37)."""
    h = hasher or fnv1_32()
    window_range = max_window_size - min_window_size + 1
    return min_window_size + h(str(idx)) % window_range
