"""Where the textured frozen set depends on the machine (ROADMAP.md §C.12):
the SHA-256 of every file of scripts/quality_report.ensure_frozen_set(
textured=True) made on the CPU, and of every stage of data/synth_clean's
images, in the order they run.

    python -m unet_watermark_tpu_torch.tools.frozen_set_probe --out F.json

writes {"files": {relative path: sha256}, "stages": {clean source index:
[[stage, sha256], ...]}, "machine": {...}} for the set of --n triads at
--size² (4 and 128: phase 3k's textured witness). Run it on two machines
and compare the files: the first stage whose hash differs names the first
operation whose bytes differ. A stage is a synth_clean helper's result
(_gradient_layer, _value_noise, fractal_noise, _fine_fbm_layer,
_grating_layer, _cellular_layer, _draw_shapes, resize_cubic_f32,
imgproc.gaussian_blur_f32) or one of the numpy float functions the module
calls (sin, cos, tanh, sqrt, exp, log), then the image's uint8 and its
JPEG's bytes; "compose" lists, in call order, every result of ops/draw.py's
and ops/pil.py's functions while gen_data composes the set.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import tempfile
import types
from typing import Dict, List, Optional

import numpy as np
import torch

NUMPY_FUNCS = ("sin", "cos", "tanh", "sqrt", "exp", "log")
HELPERS = ("_gradient_layer", "_value_noise", "fractal_noise",
           "_fine_fbm_layer", "_grating_layer", "_cellular_layer",
           "_draw_shapes", "resize_cubic_f32")


def _sha(x) -> str:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(x))
    return hashlib.sha256(arr.tobytes() + str(arr.dtype).encode()
                          ).hexdigest()[:16]


def _recording(synth, log: List):
    """Wraps synth_clean's helpers and numpy functions to append (name,
    sha) of each result to `log`; returns an undo function."""
    saved = {name: getattr(synth, name) for name in HELPERS
             if hasattr(synth, name)}
    saved_np, saved_blur = synth.np, synth.imgproc.gaussian_blur_f32

    def wrap(name, fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            log.append([name, _sha(out)])
            return out
        return recorded

    for name, fn in saved.items():
        setattr(synth, name, wrap(name, fn))
    proxy = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                     if not k.startswith("__")})
    for name in NUMPY_FUNCS:
        setattr(proxy, name, wrap(f"np.{name}", getattr(np, name)))
    synth.np = proxy
    imgproc = types.SimpleNamespace(**vars(synth.imgproc))
    imgproc.gaussian_blur_f32 = wrap("gaussian_blur_f32", saved_blur)
    saved_imgproc = synth.imgproc
    synth.imgproc = imgproc

    def undo():
        for name, fn in saved.items():
            setattr(synth, name, fn)
        synth.np = saved_np
        synth.imgproc = saved_imgproc
    return undo


def _digest(out) -> str:
    """A result's hash: arrays and tensors by their bytes, tuples and
    lists by their items', anything else by its repr."""
    if isinstance(out, (np.ndarray, torch.Tensor)):
        return _sha(out)
    if isinstance(out, (tuple, list)):
        return ",".join(_digest(x) for x in out)
    if isinstance(out, types.GeneratorType):
        return "generator"
    return repr(out)


def _record_modules(modules, log: List):
    """Wraps every function defined in each module (the callers look them
    up at call time) to append (name, digest) of each result to `log`;
    returns an undo function."""
    saved = []
    for mod in modules:
        for name, fn in list(vars(mod).items()):
            if isinstance(fn, types.FunctionType) and \
                    fn.__module__ == mod.__name__:
                def recorded(*args, __fn=fn, __name=f"{mod.__name__.split('.')[-1]}.{name}", **kwargs):
                    out = __fn(*args, **kwargs)
                    log.append([__name, _digest(out)])
                    return out
                saved.append((mod, name, fn))
                setattr(mod, name, recorded)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo


def probe(n: int = 4, size: int = 128, workdir: Optional[str] = None
          ) -> Dict:
    """The files' and the stages' hashes (see the module docstring)."""
    from ..data import synth_clean as synth
    from ..ops import draw, pil
    from ..scripts import quality_report as qr
    from ..utils import image_io

    work = workdir or tempfile.mkdtemp(prefix="frozen_probe_")
    compose: List = []
    undo = _record_modules((draw, pil), compose)
    try:
        root = qr.ensure_frozen_set(work, n=n, img_size=size,
                                    textured=True, device="cpu")
    finally:
        undo()
    files = {}
    for base in (os.path.join(work, "clean_src_tex"),
                 os.path.join(work, "logos"), root):
        for dirpath, _, names in os.walk(base):
            for name in sorted(names):
                path = os.path.join(dirpath, name)
                with open(path, "rb") as f:
                    files[os.path.relpath(path, work)] = hashlib.sha256(
                        f.read()).hexdigest()[:16]
    stages = {}
    count = max(16, n // 2)  # ensure_frozen_set's clean sources
    for i in range(count):
        log: List = []
        undo = _recording(synth, log)
        try:
            rng = np.random.default_rng(qr.TEX_CLEAN_SEED * 1_000_003 + i)
            img = synth.synth_textured_image(rng, size)
        finally:
            undo()
        log.append(["image", _sha(img)])
        log.append(["jpeg", hashlib.sha256(image_io.encode_jpeg(
            torch.from_numpy(img), 95)).hexdigest()[:16]])
        stages[str(i)] = log
    try:
        from numpy._core._multiarray_umath import __cpu_features__ as feats
        simd = sorted(k for k, v in feats.items() if v)
    except ImportError:
        simd = None
    return {"files": files, "stages": stages, "compose": compose,
            "machine": {
        "cpu": platform.processor() or platform.machine(),
        "numpy": np.__version__, "torch": torch.__version__,
        "numpy_cpu_features": simd,
        "torch_cpu_capability": torch.backends.cpu.get_cpu_capability()}}


def first_difference(a: Dict, b: Dict) -> Optional[Dict]:
    """The first clean source and stage whose hashes differ between two
    probes, with the files that differ; None where all agree."""
    files = sorted(k for k in set(a["files"]) | set(b["files"])
                   if a["files"].get(k) != b["files"].get(k))
    for i in sorted(a["stages"], key=int):
        for j, (x, y) in enumerate(zip(a["stages"][i], b["stages"][i])):
            if x != y:
                return {"source": int(i), "stage_index": j, "stage": x[0],
                        "before": a["stages"][i][max(0, j - 1)][0],
                        "files": files}
    for j, (x, y) in enumerate(zip(a.get("compose", ()),
                                   b.get("compose", ()))):
        if x != y:
            return {"compose_index": j, "call": x[0], "a": x[1], "b": y[1],
                    "calls_before": a["compose"][max(0, j - 8):j],
                    "calls_after": [[p, q] for p, q in zip(
                        a["compose"][j:j + 8], b["compose"][j:j + 8])],
                    "files": files}
    return {"files": files} if files else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--compare", help="another probe's JSON to compare")
    args = ap.parse_args(argv)
    result = probe(args.n, args.size)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    if args.compare:
        with open(args.compare) as f:
            print(json.dumps(first_difference(json.load(f), result)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
