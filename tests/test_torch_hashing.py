"""The port's hashers (``utils/hashing.py``: the FNV family in Python, every
other pyhash name over ``native/pyhashx.c`` through ctypes) against the JAX
package's:

- every algorithm with stored vectors against the 4800 golden vectors of
  ``tests/data/hash_vectors.jsonl.gz`` (one case per algorithm; lengths
  0..1200 over every block and tail path, three seeds per width), bit for
  bit;
- every name of the pyhash surface against the JAX package's C extension,
  compiled from its own source into a temporary directory (so the check
  does not depend on, or race with, the in-place build of
  ``tests/test_hashing.py``), on random data and seeds, with instance seeds,
  ``seed=`` overrides, chaining and ``str`` arguments;
- the call semantics: UTF-16LE for ``str``, chaining narrowed to the seed's
  width, 128-bit seeds, fingerprinters taking no seed and returning a list
  for several arguments, ``TypeError`` for an int.

The C source is built with ``cc`` into a temporary build directory, as the
module builds it into ``build/torch_native/`` at first use.
"""
import gzip
import importlib.util
import json
import pathlib
import subprocess
import sysconfig

import numpy as np
import pytest

from mode_diffusion_policy_tpu_torch.utils import hashing as H
from torch_threads import two_torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
VECTORS = pathlib.Path(__file__).parent / "data" / "hash_vectors.jsonl.gz"
POOL = bytes((i * 131 + 7) & 0xFF for i in range(1200))


def _golden():
    out = {}
    with gzip.open(VECTORS, "rt") as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["algo"], []).append(rec)
    return out


GOLDEN = _golden()
FNV = ("fnv1_32", "fnv1a_32", "fnv1_64", "fnv1a_64")


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The port's C hashers, built into a temporary directory."""
    lib = H.build_native(tmp_path_factory.mktemp("torch_native"))
    assert lib.exists() and lib.name.startswith("libpyhashx_")
    return H.load_native(lib.parent)


@pytest.fixture(scope="module")
def jax_ext(tmp_path_factory):
    """The JAX package's CPython extension compiled from its source into a
    temporary directory and loaded from there."""
    src = ROOT / "mode_diffusion_policy_tpu" / "native" / "pyhashx" / \
        "pyhashx.c"
    out = tmp_path_factory.mktemp("jax_native") / (
        "_pyhashx" + sysconfig.get_config_var("EXT_SUFFIX"))
    subprocess.run(["cc", "-O2", "-shared", "-fPIC",
                    f"-I{sysconfig.get_paths()['include']}", "-o", str(out),
                    str(src)], check=True, capture_output=True, timeout=300)
    spec = importlib.util.spec_from_file_location("_pyhashx", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_surface_names(native):
    """Every name of the JAX surface; the C table holds each one."""
    from mode_diffusion_policy_tpu.utils import hashing as jh
    names = [n for n in dir(jh) if not n.startswith("_")
             and isinstance(getattr(jh, n), type)]
    assert set(names) <= set(dir(H))
    assert set(H.NATIVE_NAMES) | set(FNV) == set(native.specs)
    assert len(GOLDEN) == 36 and set(GOLDEN) <= set(H.NATIVE_NAMES)


@pytest.mark.parametrize("algo", sorted(GOLDEN))
def test_golden_vectors(native, algo):
    for rec in GOLDEN[algo]:
        slo, shi = rec["seed"]
        want = sum(w << (64 * i) for i, w in enumerate(rec["val"]))
        h = getattr(H, algo)()
        data = POOL[:rec["len"]]
        got = h(data) if "fingerprint" in algo else \
            h(data, seed=slo | (shi << 64))
        assert got == want, (algo, rec["len"], slo, shi)


@pytest.mark.parametrize("name", sorted(H.NATIVE_NAMES + FNV))
def test_matches_jax_extension(native, jax_ext, name):
    r = np.random.default_rng(sorted(H.NATIVE_NAMES + FNV).index(name))
    port, jax = getattr(H, name), getattr(jax_ext, name)
    for _ in range(25):
        data = bytes(r.integers(0, 256, int(r.integers(0, 300)),
                                dtype=np.uint8))
        if "fingerprint" in name:
            assert port()(data) == jax()(data)
            assert port()(data, "héllo") == jax()(data, "héllo")
            continue
        seed = int(r.integers(0, 2 ** 63)) * int(r.integers(1, 2 ** 63))
        assert port(seed).seed == jax(seed).seed
        assert port(seed)(data, "héllo") == jax(seed)(data, "héllo")
        assert port()(data, seed=seed) == jax()(data, seed=seed)
        assert port()(np.frombuffer(data, np.uint8)) == jax()(data)


def test_call_semantics(native):
    for s in ("5", "hello world", "café", "日本語", "emoji \U0001F600"):
        assert H.murmur3_32()(s) == H.murmur3_32()(s.encode("utf-16-le"))
        assert H.fnv1_32()(s) == H.fnv1_32()(s.encode("utf-16-le"))
    # canonical vectors
    assert H.xx_32()(b"") == 0x02cc5d05
    assert H.xx_64()(b"") == 0xef46db3751d8e999
    assert H.murmur3_32()(b"hello") == 0x248bfa47
    assert H.murmur3_32()(b"Hello, world!", seed=0x9747b28c) == 0x24884cba
    assert H.fnv1a_32()(b"foobar", seed=0x811c9dc5) == 0xbf9cf968
    # chaining: the value narrowed to the seed's width seeds the next one
    m = H.metro_64_1()
    first = m(b"one")
    assert m(b"one", b"two") == m(b"two", seed=first & 0xFFFFFFFF)
    c = H.city_128()
    assert c(b"one", b"two") == c(b"two", seed=c(b"one"))
    big = (5 << 64) | 9
    h = H.city_128(big)
    assert h.seed == big and h(b"x") == H.city_128()(b"x", seed=big)
    assert h(b"x") != H.city_128()(b"x")
    # aliases share their twins' values
    assert H.t1ha0()(b"abc") == H.t1ha2_atonce()(b"abc")
    assert H.lookup3()(b"abc") == H.lookup3_little()(b"abc")
    # fingerprinters: no seed, a list for several arguments
    with pytest.raises(TypeError):
        H.farm_fingerprint_64(1)
    fp = H.farm_fingerprint_64()
    assert fp(b"a", b"b") == [fp(b"a"), fp(b"b")]
    assert H.city_fingerprint_256()(b"hello") > (1 << 128)
    with pytest.raises(TypeError):
        H.murmur3_32()(12345)
    with pytest.raises(TypeError):
        H.fnv1_32()(12345)


def test_build_failure_raises_on_construction(monkeypatch, tmp_path):
    """Without a compiler the C hashers raise when constructed (the FNV
    family does not need one)."""
    monkeypatch.setattr(H, "_native", None)
    monkeypatch.setattr(H.shutil, "which", lambda name: None)
    monkeypatch.delenv("CC", raising=False)
    monkeypatch.setattr(H, "BUILD_DIR", tmp_path / "none")
    with pytest.raises(RuntimeError, match="no C compiler"):
        H.city_64()
    assert H.fnv1_32()("5") == H.py_fnv1_32()("5")
