"""Time variants of kernel K1 (csrc/morph_chain.cu) on one GPU.

    python -m unet_watermark_tpu_torch.tools.k1_sweep \
        [--set kBand=16,32,64 --set kSeg=4,8 --set kThreads=256,512]

Each variant is the source with those compile-time constants replaced,
built with the port's nvcc flags (all builds at once) into _build/sweep/.
Each is held bit-exactly against morph_chain_plain at the main path's
shape (8 x 512², random masks, p = 0.35; K1's work does not depend on the
data), then timed with CUDA events over 50 back-to-back launches, in
turns over 3 rounds. Prints one JSON line a variant (ptxas's stack, spills
and registers for K1, the median ms) and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops.kernels import build
from ..ops.kernels import morph_chain as kc

DEFAULT = ["kBand=16,32,64", "kSeg=4,8", "kThreads=256,512"]


def _variants(sets):
    names, values = [], []
    for item in sets:
        name, vals = item.split("=")
        names.append(name)
        values.append([int(v) for v in vals.split(",")])
    return [dict(zip(names, combo)) for combo in itertools.product(*values)]


def _source(consts) -> str:
    src = (build.CSRC_DIR / kc.SOURCE).read_text()
    for name, value in consts.items():
        src, hits = re.subn(rf"constexpr int {name} = \d+;",
                            f"constexpr int {name} = {value};", src)
        if hits != 1:
            raise ValueError(f"no constant {name} in {kc.SOURCE}")
    return src


def _build_all(variants):
    """Start one nvcc a variant, all at once; returns [(lib path, ptxas)]."""
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for k, consts in enumerate(variants):
        src = out_dir / f"k1_{k}.cu"
        src.write_text(_source(consts))
        lib = out_dir / f"libk1_{k}.so"
        procs.append((lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
        k1 = log[log.index("morph_chain_kernel"):].splitlines()[2:4]
        built.append((lib, [ln.split(": ")[-1].strip() for ln in k1]))
    return built


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", action="append", dest="sets",
                    help="NAME=v1,v2,... (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_sweep: no CUDA device", file=sys.stderr)
        return 2
    variants = _variants(args.sets or DEFAULT)
    built = _build_all(variants)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fns = []
    for lib, _ in built:
        fn = ctypes.CDLL(str(lib)).uwt_morph_chain
        fn.argtypes, fn.restype = [vp, vp, ci, ci, vp], ci
        fns.append(fn)

    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random((8, 512, 512)) < 0.35)
                         .astype(np.float32)).cuda()
    out = torch.empty_like(x)
    ref = kc.morph_chain_plain(x)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn):
        rc = fn(x.data_ptr(), out.data_ptr(), 8, 512, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    for consts, fn in zip(variants, fns):
        out.zero_()
        launch(fn)
        if not torch.equal(out, ref):
            raise AssertionError(f"variant {consts} differs from the "
                                 f"plain chain")
    times = [[] for _ in fns]
    for _ in range(3):
        for k, fn in enumerate(fns):
            for _ in range(3):
                launch(fn)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(50):
                launch(fn)
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end) / 50)
    for consts, (lib, ptxas), ms in zip(variants, built, times):
        print(json.dumps({"variant": consts, "ms": float(np.median(ms)),
                          "ms_rounds": ms, "bit_exact": True,
                          "ptxas": ptxas}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
