"""Build the port's native sources and load them with ctypes.

One compiler call per source, into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds): nvcc for a CUDA
source (.cu), the host C compiler (cc, the one nvcc itself drives) for a
host source (.c). The library lands in unet_watermark_tpu_torch/_build/
(git-ignored), named by the hash of its source and flags, and is built at
first use in a process: nothing is compiled or loaded when a module is
imported. Concurrent builds of one source (test workers) each compile to a
temporary file and rename it into place.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CC_FLAGS = ["-O2", "-shared", "-fPIC"]


def nvcc() -> str:
    """nvcc from $CUDA_HOME, else from PATH, else the toolkit's default
    install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def cc() -> str:
    """The host C compiler: $CC, else cc from PATH."""
    return os.environ.get("CC") or shutil.which("cc") or "cc"


def build(source: str) -> Tuple[Path, str]:
    """Compile csrc/<source> unless a library of the same content exists.
    Returns the library's path and the compiler's output (for nvcc, ptxas's
    register and shared-memory report; empty when the library was already
    built)."""
    src = CSRC_DIR / source
    host = src.suffix == ".c"
    compiler, flags = (cc(), CC_FLAGS) if host else (nvcc(), NVCC_FLAGS)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([compiler, *flags, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
        except OSError as e:  # no compiler: not a file the reader can skip
            raise RuntimeError(f"cannot run {compiler} on {src.name}: {e}"
                               ) from None
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed on {src.name} "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and dlopen csrc/<source>; a failure raises
    RuntimeError (never an OSError, which readers take for an unreadable
    file)."""
    lib, _ = build(source)
    try:
        return ctypes.CDLL(str(lib))
    except OSError as e:
        raise RuntimeError(f"cannot load {lib.name}: {e}") from None
