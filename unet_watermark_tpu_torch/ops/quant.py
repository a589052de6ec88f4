"""The int8 post-training quantization tier (ops/quant.py in the JAX
package): the encoder's and the decoder's 3x3/7x7/1x1 convs run s8 x s8 ->
s32 with the shipped calibration sidecar's activation scales.

Scheme (the JAX package's, bit for bit):
  * weights: symmetric per-output-channel int8 of the weight in the model
    dtype, sw = amax / 127 (floor 1e-12), wq = clip(round(w / sw), ±127)
  * activations: symmetric per-tensor int8 from the sidecar's amax,
    sx = max(amax, MIN_AMAX) / 127 in doubles, xq = clip(round(x * f32(1 /
    sx)), ±127); both round half to even
  * accumulation: int32, then y = f32(acc) * (f32(sx) * sw[c]) cast to the
    model dtype

The mode is a contextvar read during the eager forward: `with
quant_int8(scales): model(x)` runs every conv that calls
conv2d_maybe_quant with a calibrated path in int8; `with
quant_observe(store): model(x)` records each conv's input amax (the
calibration hook). Outside both, a conv is the plain float conv.

The activation quantize and the int8 conv are ops/kernels/conv_s8.py's
wrappers of the hand-written kernels of csrc/conv_s8.cu on a CUDA tensor
(uwt_quantize_s8, uwt_conv_s8); quantize_s8_plain (the torch chain
_quantize) and conv_s8_plain (float64 F.conv2d on int8 values, exact since
every |sum| < 2^53) below are their plain versions, which the wrappers take
on a CPU tensor.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Smallest recordable activation amax: the quantize_activation floor.
MIN_AMAX = 1e-12


@dataclasses.dataclass
class QuantMode:
    kind: str                      # "observe" | "int8"
    scales: Dict[str, float]      # conv path -> input amax (calibrated)
    # int8: paths without a calibrated scale (they run the float conv)
    missing: Optional[set] = None
    # observe: 1.0 records the true amax; < 1.0 that |x| quantile
    quantile: float = 1.0
    # int8: prebuilt ConvPlans by path (WatermarkPredictor builds them
    # once); a path without one quantizes its weight at the call
    plans: Optional[Dict[str, "ConvPlan"]] = None


_MODE: contextvars.ContextVar[Optional[QuantMode]] = contextvars.ContextVar(
    "uwt_quant_mode", default=None)


def current_mode() -> Optional[QuantMode]:
    return _MODE.get()


@contextlib.contextmanager
def quant_int8(scales: Dict[str, float],
               plans: Optional[Dict[str, "ConvPlan"]] = None):
    """Convs with a calibrated path run s8 x s8 -> s32."""
    mode = QuantMode("int8", dict(scales), missing=set(), plans=plans)
    token = _MODE.set(mode)
    try:
        yield mode
    finally:
        _MODE.reset(token)


@contextlib.contextmanager
def quant_observe(store: Dict[str, float], quantile: float = 1.0):
    """Records each conv's input amax (or, with quantile < 1, that |x|
    quantile) into `store`, keeping the max across batches."""
    mode = QuantMode("observe", store, quantile=quantile)
    token = _MODE.set(mode)
    try:
        yield mode
    finally:
        _MODE.reset(token)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an OIHW weight: (w_int8,
    scale[Cout] float32)."""
    wf = w.float()
    sw = wf.abs().amax(dim=tuple(range(1, wf.ndim))) / 127.0
    sw = torch.clamp(sw, min=1e-12)
    shape = (-1,) + (1,) * (wf.ndim - 1)
    wq = torch.clamp(torch.round(wf / sw.view(shape)), -127.0, 127.0)
    return wq.to(torch.int8), sw


def activation_scale(amax: float) -> Tuple[float, float]:
    """(sx, 1 / sx) in doubles, as the JAX package computes them."""
    sx = max(float(amax), MIN_AMAX) / 127.0
    return sx, 1.0 / sx


def quantize_activation(x: torch.Tensor, amax: float
                        ) -> Tuple[torch.Tensor, float]:
    """Symmetric per-tensor int8 with a calibrated amax: (x_int8, sx)."""
    sx, inv = activation_scale(amax)
    return _quantize(x, inv), sx


def _quantize(x: torch.Tensor, inv: float) -> torch.Tensor:
    """clip(round(f32(x) * f32(inv)), ±127) as int8, in x's layout. The
    Python float enters the multiply as a float32 scalar, as JAX's
    weak-typed one does (a device tensor made from it would cost a
    host-to-device copy and a stream sync a conv)."""
    return torch.clamp(torch.round(x.float() * inv), -127.0,
                       127.0).to(torch.int8)


def quantize_s8_plain(x: torch.Tensor, inv: float,
                      channels: Optional[int] = None) -> torch.Tensor:
    """uwt_quantize_s8's plain version: _quantize(x, inv), with zero
    channels appended up to `channels`."""
    xq = _quantize(x, inv)
    n, c, h, w = xq.shape
    if channels is None or channels == c:
        return xq
    out = xq.new_zeros((n, channels, h, w))
    out[:, :c] = xq
    return out


def fuse_up_kernel(w3: torch.Tensor) -> torch.Tensor:
    """Fold nearest-2x upsampling into a 3x3 OIHW kernel (models/unet.py's
    fuse_up_kernel in the JAX package): K[a, b] = Σ W[a - da, b - db] over
    da, db in {0, 1}, summed in w3's dtype in the order (0,0), (0,1),
    (1,0), (1,1). conv3x3(up2x(x), W, pad 1) equals the conv of x dilated
    by 2 with K and padding 2."""
    k = torch.zeros(w3.shape[:2] + (4, 4), dtype=w3.dtype, device=w3.device)
    for da in (0, 1):
        for db in (0, 1):
            k[:, :, da:da + 3, db:db + 3] += w3
    return k


def dilate2(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → (N, C, 2H - 1, 2W - 1) with zeros between the
    pixels: the input of an lhs-dilated conv, written out."""
    n, c, h, w = x.shape
    out = x.new_zeros((n, c, 2 * h - 1, 2 * w - 1))
    out[:, :, ::2, ::2] = x
    return out


def phase_kernels(k: torch.Tensor) -> torch.Tensor:
    """The four output phases of the lhs-dilated 4x4 up-conv (padding 2,
    dilation 2): (4, O, I, 2, 2), phase 2a + b = k[:, :, a::2, b::2]. Output
    (2p + a, 2q + b) reads only taps ky = a + 2 ty, kx = b + 2 tx, at input
    (p - 1 + a + ty, q - 1 + b + tx): a 2x2 stride-1 conv of the undilated
    input."""
    return torch.stack([k[:, :, a::2, b::2] for a in (0, 1) for b in (0, 1)])


def conv_sums_phases_plain(xq: torch.Tensor, wq: torch.Tensor
                           ) -> torch.Tensor:
    """The exact int32 sums of the lhs-dilated 4x4 up-conv, as its four
    phases (phase_kernels): each a 2x2 conv of xq padded by 1 - a above
    and a below (1 - b left, b right), written to its interleaved places."""
    x = xq.double()
    n, _, h, w = x.shape
    out = x.new_zeros((n, wq.shape[0], 2 * h, 2 * w))
    for z, k in enumerate(phase_kernels(wq.double())):
        a, b = divmod(z, 2)
        xp = F.pad(x, (1 - b, b, 1 - a, a))
        out[:, :, a::2, b::2] = F.conv2d(xp, k)
    return out.to(torch.int32)


def conv_sums_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                    padding: int, dilation: int) -> torch.Tensor:
    """The exact int32 sums of an int8 conv: F.conv2d in float64 on the
    int8 values (|sum| <= 127² · K < 2^53), with the lhs-dilated input
    zero-interleaved. An activation whose channels were padded to a
    multiple of 16 (quantize_s8) meets zero weights past wq's."""
    from .kernels.conv_s8 import padded_channels

    if xq.shape[1] != wq.shape[1] and \
            xq.shape[1] == padded_channels(wq.shape[1]):
        xq = xq[:, :wq.shape[1]]
    x = xq.double()
    if dilation == 2:
        x = dilate2(x)
    elif dilation != 1:
        raise ValueError(f"lhs dilation {dilation}: only 1 and 2")
    y = F.conv2d(x, wq.double(), stride=stride, padding=padding)
    return y.to(torch.int32)


def conv_s8_plain(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                  stride: int, padding: int, dilation: int,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """uwt_conv_s8's plain version: f32(int32 sums) * scale[c], cast to
    out_dtype; NCHW in, NCHW out."""
    acc = conv_sums_plain(xq, wq, stride, padding, dilation)
    return (acc.float() * scale.view(1, -1, 1, 1)).to(out_dtype)


@dataclasses.dataclass
class ConvPlan:
    """One conv's int8 operands, built once: the int8 weight (OIHW), its
    scales sw, 1 / sx, and the epilogue's factor f32(sx) * sw; `channels`,
    the quantized activation's channel count (the input's, padded to a
    multiple of 16: the stem's 3 become 16); `packed` is the conv kernel's
    weight operand (conv_s8.pack_weight: the up-conv's four phase kernels
    for dilation 2) on a CUDA device, None on the CPU; `packed_taps` the
    TMA modes' where conv_s8.tma_form takes the conv (the 3x3 stride-1
    convs and the up-conv), on a CUDA device."""
    wq: torch.Tensor
    sw: torch.Tensor
    inv_sx: float
    scale: torch.Tensor
    channels: int
    packed: Optional[torch.Tensor] = None
    packed_taps: Optional[torch.Tensor] = None


def make_plan(w: torch.Tensor, amax: float, stride: int = 1,
              padding: int = 1, dilation: int = 1) -> ConvPlan:
    """The plan of a conv whose weight, in the model dtype, is w (OIHW),
    at that stride, padding and lhs dilation."""
    from .kernels import conv_s8

    wq, sw = quantize_weight(w)
    sx, inv = activation_scale(amax)
    scale = torch.tensor(sx, dtype=torch.float32, device=sw.device) * sw
    channels = conv_s8.padded_channels(wq.shape[1])
    plan = ConvPlan(wq, sw, inv, scale, channels)
    if wq.is_cuda:
        plan.packed = conv_s8.pack_weight(wq, dilation, channels)
        kh, kw = wq.shape[2:]
        if conv_s8.tma_form(kh, kw, stride, padding, dilation):
            plan.packed_taps = conv_s8.pack_weight(wq, dilation, channels,
                                                   taps=True)
    return plan


def _float_conv(x, w, stride, padding, dilation):
    if dilation == 2:
        x = dilate2(x)
    return F.conv2d(x, w() if callable(w) else w, stride=stride,
                    padding=padding)


def conv2d_maybe_quant(x: torch.Tensor, w, *, stride: int = 1,
                       padding: int = 1, dilation: int = 1,
                       path: str = "") -> torch.Tensor:
    """NCHW conv (no bias) that runs int8 when a quant context is active and
    `path`, the conv's flax path ("encoder/layer1_0/conv1"), has a
    calibrated scale; `dilation` is the JAX conv's lhs_dilation (1 or 2).
    Without a context, a path or a scale: the float conv in x's dtype. `w`
    is the OIHW weight in the model dtype, or a function that makes it
    (called only where no prebuilt plan holds the int8 weight)."""
    mode = _MODE.get()
    if mode is None or not path:
        return _float_conv(x, w, stride, padding, dilation)
    if mode.kind == "observe":
        ax = x.detach().abs().float()
        if mode.quantile >= 1.0:
            amax = float(ax.max())
        else:
            amax = float(torch.quantile(ax.reshape(-1), mode.quantile))
        mode.scales[path] = max(mode.scales.get(path, 0.0), amax, MIN_AMAX)
        return _float_conv(x, w, stride, padding, dilation)
    amax = mode.scales.get(path)
    if amax is None or amax <= 0.0:
        if mode.missing is not None:
            mode.missing.add(path)
        return _float_conv(x, w, stride, padding, dilation)
    from .kernels import conv_s8

    plan = mode.plans.get(path) if mode.plans is not None else None
    if plan is None:
        plan = make_plan(w() if callable(w) else w, amax, stride, padding,
                         dilation)
    xq = conv_s8.quantize_s8(x, plan.inv_sx, plan.channels)
    return conv_s8.conv_s8(xq, plan.wq, plan.scale, stride=stride,
                           padding=padding, dilation=dilation,
                           out_dtype=x.dtype, packed=plan.packed,
                           packed_taps=plan.packed_taps)


class QConv2d(nn.Conv2d):
    """nn.Conv2d (no bias) whose forward goes through conv2d_maybe_quant
    under a quant context (QConv in the JAX package); outside one it is
    nn.Conv2d's forward. `quant_path` is its flax path, which
    models/convert.py sets from the weights' names. A decoder's first conv
    has `split` = (channels of the upsampled operand, whether they come
    first): under a quant context it runs as SplitUpConcatConv
    (forward_split)."""

    quant_path = ""
    split: Optional[Tuple[int, bool]] = None

    def forward(self, x):
        if _MODE.get() is None or not self.quant_path:
            return super().forward(x)
        return conv2d_maybe_quant(x, self.weight, stride=self.stride[0],
                                  padding=self.padding[0],
                                  path=self.quant_path)

    def _up_skip(self) -> Tuple[torch.Tensor, torch.Tensor]:
        n_up, up_first = self.split
        w = self.weight
        if up_first:
            return w[:, :n_up], w[:, n_up:]
        return w[:, w.shape[1] - n_up:], w[:, :w.shape[1] - n_up]

    def quant_weights(self):
        """(path, weight maker, (stride, padding, lhs dilation)) of each
        int8 conv this module runs."""
        p = self.quant_path
        if self.split is None:
            return [(p, lambda: self.weight,
                     (self.stride[0], self.padding[0], 1))]
        out = [(p + ":up", lambda: fuse_up_kernel(self._up_skip()[0]),
                (1, 2, 2))]
        if self._up_skip()[1].shape[1]:
            out.append((p + ":skip", lambda: self._up_skip()[1], (1, 1, 1)))
        return out

    def forward_split(self, x_low: torch.Tensor,
                      skip: Optional[torch.Tensor]) -> torch.Tensor:
        """conv(concat(up2x(x_low), skip)) in the weight's channel order,
        as the sum of the lhs-dilated conv of x_low with the fused 4x4
        kernel (path ":up") and the 3x3 conv of skip (":skip"), added in
        the model dtype; no upsampled or concatenated tensor is made."""
        p = self.quant_path
        y = conv2d_maybe_quant(
            x_low, lambda: fuse_up_kernel(self._up_skip()[0]), padding=2,
            dilation=2, path=p + ":up" if p else "")
        if skip is not None:
            y = y + conv2d_maybe_quant(skip, lambda: self._up_skip()[1],
                                       padding=1,
                                       path=p + ":skip" if p else "")
        return y


def build_plans(model: nn.Module, scales: Dict[str, float]
                ) -> Dict[str, ConvPlan]:
    """The ConvPlan of every QConv2d path of `model` with a calibrated
    scale, on the model's device and in its dtype."""
    plans = {}
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, QConv2d) and mod.quant_path:
                for path, weight, form in mod.quant_weights():
                    if scales.get(path, 0.0) > 0.0:
                        plans[path] = make_plan(weight(), scales[path],
                                                *form)
    return plans


# ---------------------------------------------------------------------------
# the calibration sidecar
# ---------------------------------------------------------------------------
def quant_sidecar_path(weights_path: str) -> str:
    """Scales sidecar convention: <weights stem>.quant.json
    (scripts/calibrate_quant.py in the JAX package)."""
    return os.path.splitext(weights_path)[0] + ".quant.json"


def save_scales(path: str, scales: Dict[str, float],
                meta: Optional[Dict[str, str]] = None) -> None:
    """Write the sidecar; `meta` entries land under "__"-prefixed keys
    (__weights_sha256__ binds it to the checkpoint it was calibrated
    for)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    out: Dict[str, Any] = dict(sorted(scales.items()))
    for k, v in (meta or {}).items():
        out[f"__{k.strip('_')}__"] = v
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def load_scales(path: str) -> Dict[str, float]:
    with open(path) as f:
        return {str(k): float(v) for k, v in json.load(f).items()
                if not str(k).startswith("__")}


def load_sidecar_meta(path: str) -> Dict[str, str]:
    """The "__"-prefixed metadata entries of a sidecar."""
    with open(path) as f:
        return {str(k).strip("_"): str(v) for k, v in json.load(f).items()
                if str(k).startswith("__")}
