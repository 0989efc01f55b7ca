"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``build/lib<name>-<digest>.so`` at the repository root, at
first use, then loaded with ``ctypes``. The digest covers the source and
the flags, so an edited source builds anew and a stale library is never
loaded. Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNELS = ("paged_attention", "flash_attention", "ssd", "quant_matmul",
           "rmsnorm", "dense_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels build on the GPU host")
    return found


def lib_path(name: str, defines: Sequence[str] = ()) -> Path:
    """The library of ``csrc/<name>.cu`` built with ``-D`` each of
    ``defines`` (a planted fault's build, for instance: the digest and the
    file name tell the variants apart)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join((*NVCC_FLAGS, *(f"-D{d}" for d in defines)))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    tag = "".join(f"-{d.lower()}" for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{digest[:16]}.so"


def _start(name: str, verbose: bool, defines: Sequence[str]
           ) -> Tuple[Path, Path, subprocess.Popen]:
    out = lib_path(name, defines)
    nvcc = nvcc_path()               # raises before anything is written
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines),
           *(["-Xptxas=-v"] if verbose else []),
           "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, Path(tmp), proc


def build_all(names: Sequence[str] = KERNELS, verbose: bool = False,
              variants: Sequence[Tuple[str, Tuple[str, ...]]] = ()
              ) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source (and per
    ``(name, defines)`` of ``variants``), all started together. Returns
    the compiler's output per library built (``-Xptxas -v``
    register/shared-memory report when ``verbose``)."""
    jobs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    for name, defines in [(n, ()) for n in names] + list(variants):
        if lib_path(name, defines).exists() and not verbose:
            continue
        label = " ".join((name, *(f"-D{d}" for d in defines)))
        jobs.append((label, *_start(name, verbose, defines)))
    logs: Dict[str, str] = {}
    failed = []
    for label, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        logs[label] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{label}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """The kernel library, built on first use."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        path = lib_path(name, defines)
        if not path.exists():
            build_all([], variants=[(name, tuple(defines))])
        lib = ctypes.CDLL(str(path))
        _LIBS[key] = lib
    return lib
