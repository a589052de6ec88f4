"""Build the port's CUDA sources with nvcc and load them with ctypes.

One nvcc call per source, into a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). The library lands in
unet_watermark_tpu_torch/_build/ (git-ignored), named by the hash of its
source, and is built at first use in a process: nothing is compiled or
loaded when a module is imported.
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


def nvcc() -> str:
    """nvcc from $CUDA_HOME, else from PATH, else the toolkit's default
    install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(source: str) -> Tuple[Path, str]:
    """Compile csrc/<source> unless a library of the same content exists.
    Returns the library's path and nvcc's output (ptxas register and
    shared-memory report; empty when the library was already built)."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and dlopen csrc/<source>."""
    lib, _ = build(source)
    return ctypes.CDLL(str(lib))
