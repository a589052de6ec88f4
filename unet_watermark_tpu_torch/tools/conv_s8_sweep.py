"""Time variants of the int8 tier's kernels (csrc/conv_s8.cu) on one GPU,
on the 68 convs (or, with --quantize, the 68 activation quantizes) of one
UNet++/resnet34 int8 forward at 8 x 512².

    python -m unet_watermark_tpu_torch.tools.conv_s8_sweep \
        [--set kStages=3,4] [--sub 'OLD=>NEW|||OLD2=>NEW2' ...]
        [--timing-only] [--tile-m 64|128] [--mode gather|halo|taps]
        [--quantize]

Each variant is the source with those compile-time constants replaced (all
combinations of the --set lists) and, for every --sub, each OLD replaced
by its NEW (a variant each, beside the unchanged source), built with the
port's nvcc flags (all builds at once) into _build/sweep/. The calls are
those the predictor runs under PREDICT.QUANT on synthetic logo images with
the shipped weights and sidecar; every launch of every variant is held bit
for bit against conv_s8_plain or quantize_s8_plain (with --timing-only,
not: for diagnostic variants that leave out part of the work). Each
variant is timed with CUDA events over the 68 calls back to back, in turns
over 3 rounds; by shape
class, the kernels' device time from torch.profiler over 3 replays (a
replay of one small conv alone would time the host's launch). Prints one
JSON line a variant (ptxas's registers and spills, the median ms, the
device ms by class) and the card's name and power limit.
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

from ..configs import get_cfg_defaults
from ..inference.predict import WatermarkPredictor
from ..ops import quant
from ..ops.kernels import build
from ..ops.kernels import conv_s8 as k8
from ..utils.synthetic import watermarked_images


def _variants(sets, subs):
    names, values = [], []
    for item in sets:
        name, vals = item.split("=", 1)
        names.append(name)
        values.append(vals.split(","))
    out = [({**dict(zip(names, combo))}, None)
           for combo in itertools.product(*values)]
    return out + [({}, sub) for sub in subs]


def _source(consts, sub) -> str:
    src = (build.CSRC_DIR / k8.SOURCE).read_text()
    for name, value in consts.items():
        src, hits = re.subn(
            rf"constexpr (int|bool|long long) {name} = [-\w]+;",
            rf"constexpr \1 {name} = {value};", src)
        if hits != 1:
            raise ValueError(f"no constant {name} in {k8.SOURCE}")
    for pair in sub.split("|||") if sub else ():
        old, new = pair.split("=>", 1)
        if old not in src:
            raise ValueError(f"{old!r} is not in {k8.SOURCE}")
        src = src.replace(old, new)
    return src


def _build_all(variants):
    """Start one nvcc a variant, all at once; returns [(lib, ptxas)]."""
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for k, (consts, sub) in enumerate(variants):
        src = out_dir / f"conv_s8_{k}.cu"
        src.write_text(_source(consts, sub))
        lib = out_dir / f"libconv_s8_{k}.so"
        procs.append((lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
        regs = sorted({int(r) for r in re.findall(r"Used (\d+) registers",
                                                  log)})
        spills = sorted({int(s) for s in re.findall(
            r"(\d+) bytes spill stores", log)})
        built.append((lib, {"registers": regs, "spill_stores": spills}))
    return built


def _use(lib_path):
    """Point the wrapper at a variant's library (its C interface is the
    source's)."""
    lib = k8.bind(ctypes.CDLL(str(lib_path)))
    k8._lib = lambda: lib


def forward_calls(arch: str = "UnetPlusPlus", batch: int = 8,
                  size: int = 512):
    """The (xq, wq, scale, kwargs) of every conv_s8 call and the (x, inv,
    channels) of every quantize_s8 call of one int8 forward of `arch` on
    synthetic logo images."""
    cfg = get_cfg_defaults()
    cfg.MODEL.NAME = arch
    cfg.PREDICT.QUANT = True
    cfg.DATA.IMG_SIZE = size
    pred = WatermarkPredictor(cfg)
    convs, quantizes = [], []
    real_conv, real_quantize = k8.conv_s8, k8.quantize_s8

    def conv(xq, wq, scale, **kw):
        convs.append((xq, wq, scale, kw))
        return real_conv(xq, wq, scale, **kw)

    def quantize(x, inv, channels=None):
        quantizes.append((x, inv, channels))
        return real_quantize(x, inv, channels)

    images = torch.from_numpy(watermarked_images(batch, size, seed=0)[0])
    k8.conv_s8, k8.quantize_s8 = conv, quantize
    try:
        pred.predict_masks(images.to(pred.device))
    finally:
        k8.conv_s8, k8.quantize_s8 = real_conv, real_quantize
    return convs, quantizes


def _forced(xq, wq, kw, tile_m, mode):
    """The conv's kwargs with `tile_m` and `mode` forced where the kernel
    takes them (conv_s8.launch_config), else the wrapper's own choice."""
    n, _, h, w = xq.shape
    cout, _, kh, kwid = wq.shape
    form = (n, h, w, cout, kh, kwid, kw["stride"], kw["padding"],
            kw["dilation"], k8._sm_count(xq.get_device()))
    try:
        tile, got = k8.launch_config(*form, tile_m, mode)
    except ValueError:
        tile, got = k8.launch_config(*form, tile_m)
    return {**kw, "tile_m": tile, "mode": got}


def _shape_class(call) -> str:
    if len(call) == 3:  # a quantize
        x, _, channels = call
        return (f"{str(x.dtype)[6:]} {x.shape[1]}->{channels or x.shape[1]}"
                f" at {x.shape[2]}")
    xq, wq, _, kw = call
    return (f"{wq.shape[1]}->{wq.shape[0]} {wq.shape[2]}x{wq.shape[3]} "
            f"s{kw['stride']} d{kw['dilation']} at {xq.shape[2]}")


def _device_ms_by_class(replay, classes, kernel: str, rounds: int = 3):
    """Device ms a replay by shape class: the records of the kernels whose
    name holds `kernel` in `rounds` profiled replays, in launch order, the
    i-th that of call i; None where the profiler dropped records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a busy host's profiler may drop records
        replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                replay()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA
                      and kernel in e.name),
                     key=lambda e: e.time_range.start)
        if len(evs) == rounds * len(classes):
            break
    else:
        return None
    out = {c: 0.0 for c in classes}
    for i, e in enumerate(evs):
        out[classes[i % len(classes)]] += e.time_range.elapsed_us() / 1e3
    return {c: v / rounds for c, v in sorted(out.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", action="append", dest="sets", default=[],
                    help="NAME=v1,v2,... (repeatable)")
    ap.add_argument("--sub", action="append", dest="subs", default=[],
                    help="'OLD=>NEW|||...': a variant with that text "
                    "replaced")
    ap.add_argument("--tile-m", type=int, choices=(64, 128),
                    help="every conv's output-pixel tile (default: the "
                    "wrapper's choice)")
    ap.add_argument("--mode", choices=k8.MODES,
                    help="every conv in this mode where the kernel takes "
                    "it in that mode (default: the wrapper's choice; gather "
                    "takes every conv)")
    ap.add_argument("--quantize", action="store_true",
                    help="time the forward's activation quantizes, not its "
                    "convs")
    ap.add_argument("--timing-only", action="store_true",
                    help="time variants without holding them against the "
                    "plain versions")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_s8_sweep: no CUDA device", file=sys.stderr)
        return 2
    variants = _variants(args.sets, args.subs)
    built = _build_all(variants)
    convs, quantizes = forward_calls()
    if args.quantize:
        calls, kernel, fn = quantizes, "quantize_s8", lambda c: \
            k8.quantize_s8(*c)
        refs = [quant.quantize_s8_plain(*c) for c in calls]
    else:
        calls, kernel, fn = convs, "conv_s8_kernel", lambda c: \
            k8._conv_s8(c[0], c[1], c[2], **c[3])
        if args.tile_m or args.mode:
            calls = [(x, w, s, _forced(x, w, kw, args.tile_m, args.mode))
                     for x, w, s, kw in calls]
        refs = [quant.conv_s8_plain(x, w, s, kw["stride"], kw["padding"],
                                    kw["dilation"], kw["out_dtype"])
                for x, w, s, kw in calls]
    classes = [_shape_class(c) for c in calls]
    main_lib = k8._lib
    times = [[] for _ in built]
    by_class = []

    def replay():
        for c in calls:
            fn(c)

    def timed(fn, iters=5):
        for _ in range(2):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    try:
        for (lib, _), (consts, sub) in zip(built, variants):
            _use(lib)
            for c, ref in zip(calls, refs):
                if not args.timing_only and not torch.equal(fn(c), ref):
                    raise AssertionError(f"variant {consts} {sub} differs "
                                         f"from the plain version on "
                                         f"{_shape_class(c)}")
        for _ in range(3):
            for k, (lib, _) in enumerate(built):
                _use(lib)
                times[k].append(timed(replay))
        for lib, _ in built:
            _use(lib)
            by_class.append(_device_ms_by_class(replay, classes, kernel))
    finally:
        k8._lib = main_lib
    for (consts, sub), (_, ptxas), t, dev in zip(variants, built, times,
                                                 by_class):
        print(json.dumps({
            "variant": consts, "sub": sub, "ms": float(np.median(t)),
            "ms_rounds": t, "device_ms_by_shape": dev,
            "calls_by_shape": {c: classes.count(c) for c in sorted(
                set(classes))},
            "bit_exact": not args.timing_only, "ptxas": ptxas}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
