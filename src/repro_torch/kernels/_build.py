"""Build the port's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled by `nvcc`
for `sm_90a` into `build/repro_torch/lib<name>-<hash>.so` at the root of
the checkout (the hash covers the source, the shared `csrc/*.cuh`
headers and the flags, so an edited source never loads a stale library)
and loaded with `ctypes`.  Nothing
runs when this module is imported: the first CUDA tensor that reaches a
kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the port's CUDA kernels are built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    """Where the library built from `csrc/<name>.cu` lives."""
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output (`-Xptxas -v`: registers, spills) of the
    library `library_path(name)`."""
    return library_path(name).with_suffix(".log")


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library exists; raise with the
    compiler's output if `nvcc` fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = library_path(name)
    if lib.exists():
        return lib
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log_path(name).write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib
