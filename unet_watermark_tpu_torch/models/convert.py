"""Flat flax weights (models/torch_import.py's name and layout map in the
JAX package, copied) → the port's state_dict.

  params/encoder/conv1/kernel          → encoder.conv1.weight (HWIO → OIHW)
  params/encoder/bn1/{scale,bias}      → encoder.bn1.{weight,bias}
  batch_stats/.../bn1/{mean,var}       → ...bn1.running_{mean,var}
  params/encoder/layer{L}_{B}/...      → encoder.layer{L}.{B}....
  .../downsample_conv, downsample_bn   → ....downsample.0, .downsample.1
  params/decoder/block{i}/convJ/conv   → decoder.blocks.{i}.convJ.0
  params/decoder/block{i}/convJ/bn     → decoder.blocks.{i}.convJ.1
  params/decoder/x_{i}_{j}_convJ/conv  → decoder.x_{i}_{j}_convJ.0 (UNet++)
  params/decoder/x_{d}_{l}/convJ/conv  → decoder.blocks.x_{d}_{l}.convJ.0
                                         (UNet++, MODEL.DECODER_IMPL smp)
  params/decoder/final_block/convJ/bn  → decoder.final_block.convJ.1
  params/segmentation_head/conv        → segmentation_head.0

and the rest of the zoo as JAX's _torch_name names it:

  params/encoder/layer{L}_{B}/conv3    → encoder.layer{L}.{B}.conv3 (bottleneck)
  params/encoder/block{i}/expand_conv  → encoder.blocks.{i}.expand_conv
                                         (EfficientNet; se/reduce, dw_bn, ...)
  params/decoder/block{i}/conv1/conv   → decoder.blocks.{i}.conv1.0 (MAnet)
  params/decoder/conv/conv, conv/bn    → decoder.conv.0, .1 (DeepLabV3)
  params/decoder/seg0_conv0/conv       → decoder.seg0_conv0.conv (a
                                         ConvBnRelu not named conv*)
  params/decoder/aspp/b1_bn/scale      → decoder.aspp.b1_bn.weight

and the FFC-LaMa generator's and discriminator's (models/lama.py;
lama_torch_name):

  params/stem/kernel                   → stem.weight
  params/block{i}/ffc1/g2g/reduce/...  → blocks.{i}.ffc1.g2g.reduce....
  params/up{i}/kernel                  → up{i}.weight (ConvTranspose2d)
  params/conv{i}/{kernel,bias}         → conv{i}.{weight,bias} (PatchGAN)
  params/norm{i}/{scale,bias}          → norm{i}.{weight,bias} (GroupNorm)
  params/head/{kernel,bias}            → head.{weight,bias}

and the latent-diffusion models' (diffusion/latent_diffusion.py; ld_torch_name,
keys without a collection, as that .npz holds them):

  ae/enc/down0/kernel                  → ae.enc.down0.weight
  denoiser/down0a/emb/kernel           → denoiser.down0a.emb.weight (Dense)

A conv kernel goes HWIO → OIHW, a dense kernel (in, out) → (out, in). A
ConvTranspose2d kernel goes (kh, kw, in, out) → (in, out, kh, kw), flipped
in both spatial axes: flax's ConvTranspose (transpose_kernel=False)
convolves the dilated input with the kernel as it is, torch's with the
kernel flipped.

flax_name inverts torch_name, and to_flax takes a segmentation model's
state_dict back to flat flax weights (OIHW → HWIO), the tree a trained
model is saved as (utils/shipping.save_params_npz); module_to_flax does
the same for the LaMa and latent-diffusion modules by module type.
"""
from __future__ import annotations

import re
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from ..ops.quant import QConv2d

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}
# a ConvBnRelu whose conv and bn are .0 and .1: convJ of a Unet block,
# final_block or MFAB, conv of DeepLabV3, x_{i}_{j}_convJ of UNet++
_CONV_BN = re.compile(r"(x_\d+_\d+_)?conv\d*")
# a BatchNorm: bn, bnJ, downsample_bn, expand_bn, b1_bn, ...
_BN = re.compile(r"(\w+_)?bn\d*")
# a block of the SMP-layout UNet++ decoder, decoder.blocks.x_{d}_{l}
_SMP_BLOCK = re.compile(r"x_\d+_\d+")


def _path_and_leaf(flax_key: str):
    """'params/a/b/kernel' → (['a', 'b'], 'weight')."""
    collection, *parts = flax_key.split("/")
    leaf = parts.pop()
    leaf_map = _PARAM_LEAF if collection == "params" else _STAT_LEAF
    if collection not in ("params", "batch_stats") or leaf not in leaf_map:
        raise KeyError(f"no port counterpart for weight '{flax_key}'")
    return parts, leaf_map[leaf]


def torch_name(flax_key: str) -> str:
    """'params/encoder/layer1_0/conv1/kernel' → 'encoder.layer1.0.conv1.weight'."""
    parts, leaf = _path_and_leaf(flax_key)
    segs = []
    for p in parts:
        m = re.fullmatch(r"layer(\d+)_(\d+)", p)
        if m:
            segs.append(f"layer{m.group(1)}.{m.group(2)}")
        elif _SMP_BLOCK.fullmatch(p):
            segs.append("blocks." + p)
        elif re.fullmatch(r"block\d+", p):
            segs.append("blocks." + p[len("block"):])
        elif p == "downsample_conv":
            segs.append("downsample.0")
        elif p == "downsample_bn":
            segs.append("downsample.1")
        elif p == "conv" and segs and (_CONV_BN.fullmatch(segs[-1])
                                       or segs[-1] == "segmentation_head"):
            segs[-1] += ".0"
        elif p == "bn" and segs and _CONV_BN.fullmatch(segs[-1]):
            segs[-1] += ".1"
        else:
            segs.append(p)
    return ".".join(segs) + "." + leaf


def flax_name(name: str) -> str:
    """'encoder.layer1.0.conv1.weight' → 'params/encoder/layer1_0/conv1/kernel';
    running statistics go to 'batch_stats/...{mean,var}'."""
    *mods, leaf = name.split(".")
    segs, i = [], 0
    while i < len(mods):
        p = mods[i]
        nxt = mods[i + 1] if i + 1 < len(mods) else None
        if re.fullmatch(r"layer\d+", p) and nxt is not None and nxt.isdigit():
            segs.append(f"{p}_{nxt}")
        elif p == "blocks":
            segs.append(nxt if _SMP_BLOCK.fullmatch(nxt) else f"block{nxt}")
        elif p == "downsample":
            segs.append("downsample_conv" if nxt == "0" else "downsample_bn")
        elif nxt in ("0", "1") and (_CONV_BN.fullmatch(p)
                                    or p == "segmentation_head"):
            segs += [p, "conv" if nxt == "0" else "bn"]
        else:
            segs.append(p)
            i += 1
            continue
        i += 2
    path = "/".join(segs)
    if leaf in ("running_mean", "running_var"):
        return f"batch_stats/{path}/{leaf[len('running_'):]}"
    if leaf == "weight":
        leaf = "scale" if _BN.fullmatch(segs[-1]) else "kernel"
    if leaf not in ("kernel", "scale", "bias"):
        raise KeyError(f"no flax counterpart for '{name}'")
    return f"params/{path}/{leaf}"


def to_flax(model: nn.Module) -> Dict[str, np.ndarray]:
    """A segmentation model's weights as flat flax float32 arrays (conv
    kernels OIHW → HWIO), every parameter and running statistic; the
    inverse of load_flax_weights."""
    out = {}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        arr = t.detach().float().cpu().numpy()
        if arr.ndim == 4:
            arr = np.transpose(arr, (2, 3, 1, 0))
        out[flax_name(name)] = np.ascontiguousarray(arr)
    return out


def lama_torch_name(flax_key: str) -> str:
    """'params/block3/ffc1/g2g/reduce/kernel' →
    'blocks.3.ffc1.g2g.reduce.weight'."""
    parts, leaf = _path_and_leaf(flax_key)
    segs = [re.sub(r"^block(\d+)$", r"blocks.\1", p) for p in parts]
    return ".".join(segs) + "." + leaf


def lama_flax_path(module_name: str) -> str:
    """'blocks.3.ffc1.g2g.reduce' → 'block3/ffc1/g2g/reduce'."""
    return re.sub(r"^blocks\.(\d+)", r"block\1", module_name).replace(
        ".", "/")


def ld_torch_name(flax_key: str) -> str:
    """'denoiser/down0a/emb/kernel' → 'denoiser.down0a.emb.weight'."""
    parts, leaf = _path_and_leaf("params/" + flax_key)
    return ".".join(parts) + "." + leaf


def ld_flax_path(module_name: str) -> str:
    return module_name.replace(".", "/")


_NORMS = (nn.BatchNorm2d, nn.GroupNorm)


def module_to_flax(model: nn.Module, path_fn: Callable[[str], str],
                   params: str = "params/", stats: str = "batch_stats/"
                   ) -> Dict[str, np.ndarray]:
    """`model`'s parameters and running statistics as flat flax float32
    arrays, named by module type: a conv, transposed conv or dense
    weight is a kernel (laid out as flax lays it), a norm's weight a
    scale; `path_fn` maps a module's name to its flax path. The inverse
    of load_flax_weights with the matching name map."""
    out = {}
    for mname, mod in model.named_modules():
        leaves = dict(mod.named_parameters(recurse=False))
        leaves.update((k, v) for k, v in mod.named_buffers(recurse=False)
                      if k.startswith("running_"))
        for leaf, t in leaves.items():
            arr = t.detach().float().cpu().numpy()
            if leaf == "weight" and isinstance(mod, nn.ConvTranspose2d):
                arr = np.transpose(arr[:, :, ::-1, ::-1], (2, 3, 0, 1))
            elif leaf == "weight" and isinstance(mod, nn.Linear):
                arr = arr.T
            elif arr.ndim == 4:
                arr = np.transpose(arr, (2, 3, 1, 0))
            if leaf.startswith("running_"):
                key = f"{stats}{path_fn(mname)}/{leaf[len('running_'):]}"
            else:
                name = "bias" if leaf == "bias" else (
                    "scale" if isinstance(mod, _NORMS) else "kernel")
                key = f"{params}{path_fn(mname)}/{name}"
            out[key] = np.ascontiguousarray(arr)
    return out


def to_state_dict(flat: Dict[str, np.ndarray], model: nn.Module,
                  name_fn: Callable[[str], str] = torch_name
                  ) -> Dict[str, torch.Tensor]:
    """Map every flax weight onto `model`'s state_dict (float32 CPU
    tensors; `model` may live on the meta device).

    Raises if a flax weight has no place in the model, if a shape differs,
    or if a parameter or running statistic of the model gets no weight —
    so a successful return means every key was used exactly once.
    """
    target = model.state_dict()
    transposed = {f"{m}.weight" for m, mod in model.named_modules()
                  if isinstance(mod, nn.ConvTranspose2d)}
    dense = {f"{m}.weight" for m, mod in model.named_modules()
             if isinstance(mod, nn.Linear)}
    out = {}
    for key, arr in flat.items():
        name = name_fn(key)
        if name not in target:
            raise KeyError(f"weight '{key}' → '{name}' is not in the model")
        if name in out:
            raise KeyError(f"two weights map to '{name}'")
        if name in transposed:  # (kh, kw, in, out) → (in, out, kh, kw)
            arr = np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1]
        elif name in dense:  # (in, out) → (out, in)
            arr = arr.T
        elif arr.ndim == 4:  # conv HWIO → OIHW
            arr = np.transpose(arr, (3, 2, 0, 1))
        # a copy: the model's tensors must not share memory with the
        # caller's arrays (training updates them in place)
        t = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
        if tuple(t.shape) != tuple(target[name].shape):
            raise ValueError(f"shape of '{key}' {tuple(t.shape)} != "
                             f"'{name}' {tuple(target[name].shape)}")
        out[name] = t
    missing = [k for k in target
               if k not in out and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"{len(missing)} model weights got no value, "
                       f"e.g. {missing[:3]}")
    for k in target:
        if k.endswith("num_batches_tracked"):
            out[k] = torch.zeros((), dtype=torch.long)
    return out


def load_flax_weights(model: nn.Module, flat: Dict[str, np.ndarray],
                      name_fn: Callable[[str], str] = torch_name) -> int:
    """Load flat flax weights into `model` in place (its tensors are
    replaced, so a model built on the meta device gets real ones); returns
    the number used. Each ops/quant.QConv2d gets its kernel's flax path as
    `quant_path` ('params/encoder/conv1/kernel' → 'encoder/conv1'), the key
    of its activation scale in the int8 tier's sidecar."""
    sd = to_state_dict(flat, model, name_fn)
    model.load_state_dict(sd, strict=True, assign=True)
    for key in flat:
        if key.startswith("params/") and key.endswith("/kernel"):
            mod = model.get_submodule(name_fn(key)[:-len(".weight")])
            if isinstance(mod, QConv2d):
                mod.quant_path = key[len("params/"):-len("/kernel")]
    return len(flat)


def load_lama_weights(model: nn.Module, flat: Dict[str, np.ndarray]) -> int:
    """load_flax_weights for models/lama.py's LamaGenerator."""
    return load_flax_weights(model, flat, lama_torch_name)
