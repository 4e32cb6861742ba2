"""Build the port's CUDA kernels with plain ``nvcc`` at first use.

Each ``csrc/*.cu`` source becomes its own shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, no
``torch.utils.cpp_extension``, no ninja: such a build takes seconds). The
``nvcc`` calls of all sources that need building start together. A library
lands in ``<repo>/build/torch_kernels/`` (listed in ``.gitignore``) under a
name that carries a hash of its source, of every ``csrc/*.cuh`` header and
of the flags, so an edit to a source or a header rebuilds it and an
unchanged tree reuses it.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME/bin``, then ``PATH``, then ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels of "
        "mode_diffusion_policy_tpu_torch are built from csrc/ at first use "
        "and need the CUDA toolkit")


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def headers():
    return sorted(CSRC_DIR.glob("*.cuh"))


def library_path(source: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [source, *headers()]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every kernel whose library for the current sources does not
    exist yet, one ``nvcc`` process per source, all started together.
    Returns {source stem: library path}. The compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    library as ``<name>.log``."""
    libs = {src.stem: library_path(src) for src in sources()}
    todo = [(src, libs[src.stem]) for src in sources()
            if not libs[src.stem].exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    procs = []
    for src, lib in todo:
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(src)]
        procs.append((lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for lib, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + log)
        if proc.returncode != 0:
            failed.append(f"{lib.name}: nvcc failed ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build if needed, then load the library of ``csrc/<name>.cu`` (once)."""
    return ctypes.CDLL(str(build()[name]))
