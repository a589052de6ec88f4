"""The int8 tier's convolution as a hand-written CUDA kernel
(csrc/conv_s8.cu, uwt_conv_s8): s8 x s8 -> s32 implicit GEMM with the
dequantizing epilogue, for every conv form of the two archs (7x7/s2 stem,
3x3 at stride 1 and 2, 1x1/s2 downsample, the lhs-dilated 4x4 up-conv).

conv_s8(xq, wq, scale, ...) takes an int8 (N, Cin, H, W) activation, an
int8 OIHW weight and the fp32 per-channel epilogue factor. On a CUDA
tensor it launches the kernel on the current stream (or raises): the
activation must be channels_last, the output is channels_last too. On a
CPU tensor it runs ops/quant.conv_s8_plain, which chip_smoke.py also holds
the kernel against on the card. `conv_s8.launches` counts the kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

SOURCE = "conv_s8.cu"
K_STEP = 64  # kBK in the source: the packed weight's K is a multiple


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.uwt_conv_s8.argtypes = [vp, vp, vp, vp] + [ci] * 14 + [vp]
    lib.uwt_conv_s8.restype = ci
    lib.uwt_conv_s8_error_string.argtypes = [ci]
    lib.uwt_conv_s8_error_string.restype = ctypes.c_char_p
    return lib


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """OIHW int8 → the kernel's [Cout][Kpad] rows, k = (ky * KW + kx) * Cin
    + ci, zero from K = KH * KW * Cin up to a multiple of K_STEP."""
    cout = wq.shape[0]
    flat = wq.permute(0, 2, 3, 1).reshape(cout, -1)
    k = flat.shape[1]
    out = torch.zeros((cout, -(-k // K_STEP) * K_STEP), dtype=torch.int8,
                      device=wq.device)
    out[:, :k] = flat
    return out


def out_size(h: int, kh: int, stride: int, padding: int,
             dilation: int) -> int:
    """The output side of a conv over an input of side h dilated by
    `dilation` (lhs) and padded by `padding` on each side."""
    return ((h - 1) * dilation + 1 + 2 * padding - kh) // stride + 1


def conv_s8(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
            stride: int = 1, padding: int = 1, dilation: int = 1,
            out_dtype: torch.dtype = torch.bfloat16,
            packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = out_dtype(f32(conv(xq, wq) in int32) * scale[c]), NCHW. `packed`
    is pack_weight(wq), made here where it is not given."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"conv_s8: int8 operands, got {xq.dtype}, "
                        f"{wq.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv_s8: output bf16 or fp32, got {out_dtype}")
    if xq.ndim != 4 or wq.ndim != 4 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"conv_s8: shapes {tuple(xq.shape)} and "
                         f"{tuple(wq.shape)} do not make a conv")
    if dilation not in (1, 2):
        raise ValueError(f"conv_s8: lhs dilation {dilation}: only 1 and 2")
    if xq.is_cpu:
        from ..quant import conv_s8_plain
        return conv_s8_plain(xq, wq, scale, stride, padding, dilation,
                             out_dtype)
    if not xq.is_cuda:
        raise ValueError(f"conv_s8: unsupported device {xq.device}")
    if not xq.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv_s8: the activation must be channels_last")
    n, cin, h, w = xq.shape
    cout, _, kh, kw = wq.shape
    if packed is None:
        packed = pack_weight(wq)
    scale = scale.to(device=xq.device, dtype=torch.float32).contiguous()
    if packed.device != xq.device or not packed.is_contiguous() or \
            packed.shape[0] != cout or packed.shape[1] % K_STEP or \
            packed.shape[1] < kh * kw * cin or scale.numel() != cout:
        raise ValueError("conv_s8: packed weight or scale does not fit")
    ho = out_size(h, kh, stride, padding, dilation)
    wo = out_size(w, kw, stride, padding, dilation)
    y = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=xq.device)
    if y.numel():
        dev = xq.get_device()
        if dev != torch._C._cuda_getDevice():
            with torch.cuda.device(dev):
                return _wrapper(xq, wq, scale, stride=stride,
                                padding=padding, dilation=dilation,
                                out_dtype=out_dtype, packed=packed)
        lib = _lib()
        rc = lib.uwt_conv_s8(
            xq.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
            n, h, w, cin, ho, wo, cout, kh, kw, stride, padding, dilation,
            packed.shape[1], int(out_dtype == torch.bfloat16),
            torch._C._cuda_getCurrentRawStream(dev))
        if rc != 0:
            msg = lib.uwt_conv_s8_error_string(rc).decode()
            raise RuntimeError(f"conv_s8: CUDA error {rc} ({msg})")
        _wrapper.launches += 1
    return y.permute(0, 3, 1, 2)


# the wrapper itself, whose count a caller that wraps the module's
# conv_s8 (chip_smoke.py holds each launch against the plain version so)
# still reads
_wrapper = conv_s8
conv_s8.launches = 0


def reset_launch_counts() -> None:
    _wrapper.launches = 0
