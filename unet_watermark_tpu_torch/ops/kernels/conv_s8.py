"""The int8 tier's two hand-written CUDA kernels (csrc/conv_s8.cu):

* uwt_quantize_s8, the activation quantize: xq = clip(rint(f32(x) *
  f32(1 / sx)), ±127) as int8 in one pass over a channels_last bf16 or fp32
  activation, optionally written with its channels padded to a multiple of
  16 with zeros (the 3-channel stem);
* uwt_conv_s8, the convolution: s8 x s8 -> s32 implicit GEMM on wgmma with
  the dequantizing epilogue, for every conv form of the two archs (7x7/s2
  stem, 3x3 at stride 1 and 2, 1x1/s2 downsample, and the lhs-dilated 4x4
  up-conv, run as its four 2x2 output phases).

quantize_s8(x, inv, channels) and conv_s8(xq, wq, scale, ...) take NCHW
shapes. On a CUDA tensor each launches its kernel on the current stream
(or raises): the activation must be channels_last, and so is the output.
On a CPU tensor each runs its plain version (ops/quant.quantize_s8_plain,
ops/quant.conv_s8_plain), which chip_smoke.py also holds the kernels
against on the card. `quantize_s8.launches` and `conv_s8.launches` count
the launches.

pack_weight makes the conv kernel's weight operands once a conv
(ConvPlan): [phases][K / 128][Cout_pad][128] int8, the shared-memory image
of each step's B tile in the gather mode, and for the convs the TMA modes
take (tma_form) [phases][chunks][kh][kw][Cout_pad][chunk] (see the
source's notes).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import build

SOURCE = "conv_s8.cu"
K_STEP = 128  # kBK in the source: the packed weight's K is a multiple
TILE_N = (16, 32, 64, 128)  # the kernel's output-channel tile widths


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from SOURCE."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.uwt_conv_s8.argtypes = [vp, vp, vp, vp] + [ci] * 17 + [vp]
    lib.uwt_conv_s8.restype = ci
    lib.uwt_quantize_s8.argtypes = [vp, vp, ctypes.c_longlong, ci, ci,
                                    ctypes.c_float, ci, vp]
    lib.uwt_quantize_s8.restype = ci
    lib.uwt_conv_s8_error_string.argtypes = [ci]
    lib.uwt_conv_s8_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    return bind(build.load(SOURCE))


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def padded_channels(c: int) -> int:
    """The channel count the conv kernel reads an activation of c channels
    at: c rounded up to a multiple of 16 (its 16-byte pieces)."""
    return -(-c // 16) * 16


def tile_n(cout: int) -> int:
    """The output-channel tile of a conv with cout channels."""
    for bn in TILE_N:
        if cout <= bn:
            return bn
    return TILE_N[-1]


def _gemm_shape(cout: int, cin: int, kh: int, kw: int, dilation: int):
    """(phases, K rounded up to K_STEP, the channel tile, Cout rounded up
    to it)."""
    phases, taps = (4, 4) if dilation == 2 else (1, kh * kw)
    bn = tile_n(cout)
    return phases, -(-taps * cin // K_STEP) * K_STEP, bn, -(-cout // bn) * bn


MODES = ("gather", "halo", "taps")  # the kernel's ways of loading A


def tma_chunk(cin: int) -> int:
    """The TMA modes' channel chunk in bytes: a row of the 32-, 64- or
    128-byte swizzle."""
    return 32 if cin <= 32 else 64 if cin <= 64 else K_STEP


def tma_form(kh: int, kw: int, stride: int, padding: int,
             dilation: int) -> bool:
    """Whether the kernel's TMA modes take the conv: the 3x3 stride-1 conv
    with padding 1, or the up-conv's 2x2 phases."""
    return dilation == 2 or (kh, kw, stride, padding) == (3, 3, 1, 1)


def conv_mode(kh: int, kw: int, stride: int, padding: int, dilation: int,
              rows: int, row: int, tile_m: int, cout: int = 0) -> str:
    """How the kernel loads A for a conv of `cout` channels whose output
    grid (a phase's, for the up-conv) is rows x row pixels, in tiles of
    tile_m: "halo" where a tile lies in one row (one TMA box a row, read by
    its taps), "taps" where a tile is whole rows of one image (one TMA box
    a tap; also preferred for 128-channel tiles, whose halo steps hold
    three taps' B tiles and leave room for one block an SM), else "gather"
    (cp.async 16-byte pieces)."""
    if tma_form(kh, kw, stride, padding, dilation):
        taps = tile_m % row == 0 and rows % (tile_m // row) == 0
        if row % tile_m == 0 and not (taps and tile_n(cout) == 128):
            return "halo"
        if taps:
            return "taps"
    return "gather"


def pack_weight(wq: torch.Tensor, dilation: int = 1,
                channels: Optional[int] = None,
                taps: bool = False) -> torch.Tensor:
    """OIHW int8 → the conv kernel's [phases][K / K_STEP][Cout_pad][K_STEP]
    bytes. Row k of a phase's GEMM operand is (ty * TW + tx) * channels +
    ci of its (TH, TW) kernel: the whole kernel (one phase), or for the
    lhs-dilated up-conv (dilation 2) the four 2x2 phase kernels of
    quant.phase_kernels. With `taps`, [phases][chunks][TH][TW][Cout_pad]
    [chunk]: each tap's channel chunks (tma_chunk bytes: the TMA modes'
    order). Input channels from the weight's up to `channels` (the
    activation's, padded; to whole chunks with `taps`), K past the taps and
    rows past Cout are zero; 16-byte piece j of row r (of b bytes: 128, or
    the chunk) is stored at piece j ^ ((r * b >> 7) % (b / 16)), the
    swizzle of b-byte rows the kernel's wgmma reads."""
    from ..quant import phase_kernels

    cout, cin, kh, kw = wq.shape
    channels = cin if channels is None else channels
    if channels > cin:
        wide = wq.new_zeros((cout, channels, kh, kw))
        wide[:, :cin] = wq
        wq = wide
    kernels = phase_kernels(wq) if dilation == 2 else wq[None]
    phases, _, _, th, tw = kernels.shape
    _, kpad, _, cout_pad = _gemm_shape(cout, channels, kh, kw, dilation)
    row = K_STEP
    if taps:
        row = tma_chunk(channels)
        chunks = -(-channels // row)
        full = wq.new_zeros((phases, cout_pad, chunks * row, th, tw))
        full[:, :cout, :channels] = kernels
        tiles = full.view(phases, cout_pad, chunks, row, th, tw).permute(
            0, 2, 4, 5, 1, 3)
    else:
        k = th * tw * channels
        full = wq.new_zeros((phases, cout_pad, kpad))
        full[:, :cout, :k] = kernels.permute(0, 1, 3, 4, 2).reshape(
            phases, cout, k)
        tiles = full.view(phases, cout_pad, kpad // K_STEP, K_STEP).permute(
            0, 2, 1, 3)
    shape, pieces = tiles.shape, row // 16
    tiles = tiles.reshape(-1, cout_pad, pieces, 16)
    r = torch.arange(cout_pad, device=wq.device)
    swz = torch.arange(pieces, device=wq.device)[None, :] ^ (
        (r[:, None] * row >> 7) & (pieces - 1))
    idx = swz.view(1, cout_pad, pieces, 1).expand(tiles.shape)
    return torch.gather(tiles, 2, idx).reshape(shape).contiguous()


def out_size(h: int, kh: int, stride: int, padding: int,
             dilation: int) -> int:
    """The output side of a conv over an input of side h dilated by
    `dilation` (lhs) and padded by `padding` on each side."""
    return ((h - 1) * dilation + 1 + 2 * padding - kh) // stride + 1


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.uwt_conv_s8_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def quantize_s8(x: torch.Tensor, inv: float,
                channels: Optional[int] = None) -> torch.Tensor:
    """clip(rint(f32(x) * f32(inv)), ±127) as int8, NCHW (channels_last on
    the card), with `channels` (x's, or padded_channels of them) channels:
    zeros past x's. `inv` is 1 / sx as a Python float."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_s8: bf16 or fp32 input, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"quantize_s8: an NCHW activation, got "
                         f"{tuple(x.shape)}")
    n, c, h, w = x.shape
    channels = c if channels is None else channels
    if channels not in (c, padded_channels(c)):
        raise ValueError(f"quantize_s8: {channels} output channels for "
                         f"{c}: {c} or {padded_channels(c)}")
    if x.is_cpu:
        from ..quant import quantize_s8_plain
        return quantize_s8_plain(x, inv, channels)
    if not x.is_cuda:
        raise ValueError(f"quantize_s8: unsupported device {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("quantize_s8: the activation must be channels_last")
    y = torch.empty((n, channels, h, w), dtype=torch.int8, device=x.device,
                    memory_format=torch.channels_last)
    if y.numel():
        dev = x.get_device()
        if dev != torch._C._cuda_getDevice():
            with torch.cuda.device(dev):
                return _quantize_wrapper(x, inv, channels)
        lib = _lib()
        rc = lib.uwt_quantize_s8(
            x.data_ptr(), y.data_ptr(), n * h * w, c, channels, inv,
            int(x.dtype == torch.bfloat16),
            torch._C._cuda_getCurrentRawStream(dev))
        _raise_on(lib, rc, "quantize_s8")
        _quantize_wrapper.launches += 1
    return y


def launch_config(n: int, h: int, w: int, cout: int, kh: int, kw: int,
                  stride: int, padding: int, dilation: int, sm_count: int,
                  tile_m: Optional[int] = None,
                  mode: Optional[str] = None) -> Tuple[int, str]:
    """(output-pixel tile, A mode) of the conv kernel for a conv of an
    (n, *, h, w) activation with `cout` channels. The tile is 64 where
    128-row tiles would number fewer than two an SM, where the output row
    is a multiple of 64 but not of 128, or for a TMA mode's 128-channel
    tile (shared memory), else 128; the mode is conv_mode's. A `tile_m` or
    `mode` given forces it (the card tests and tools/conv_s8_sweep.py):
    gather takes every conv, a TMA mode that does not take it raises."""
    if tile_m not in (None, 64, 128):
        raise ValueError(f"conv_s8: tile_m {tile_m}: 64 or 128")
    if mode not in (None,) + MODES:
        raise ValueError(f"conv_s8: mode {mode}: one of {MODES}")
    phases, _, bn, cout_pad = _gemm_shape(cout, 0, kh, kw, dilation)
    # the kernel's output grid (a phase's for the up-conv), in pixels
    rows, row = (h, w) if dilation == 2 else (
        out_size(h, kh, stride, padding, dilation),
        out_size(w, kw, stride, padding, dilation))
    tma = mode != "gather" and tma_form(kh, kw, stride, padding, dilation)
    if tile_m is None:
        tiles = -(-n * rows * row // 128) * (cout_pad // bn) * phases
        tile_m = 64 if tiles < 2 * sm_count else 128
        if row % tile_m and row % 64 == 0 or tma and bn == 128:
            tile_m = 64
    takes = conv_mode(kh, kw, stride, padding, dilation, rows, row, tile_m,
                      cout)
    if takes != "gather" and bn == 128 and tile_m != 64:
        takes = "gather"
    if mode not in (None, "gather", takes):
        raise ValueError(f"conv_s8: the {mode} mode does not take this conv")
    return tile_m, takes if mode is None else mode


def conv_s8(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
            stride: int = 1, padding: int = 1, dilation: int = 1,
            out_dtype: torch.dtype = torch.bfloat16,
            packed: Optional[torch.Tensor] = None,
            packed_taps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = out_dtype(f32(conv(xq, wq) in int32) * scale[c]), NCHW. xq may
    carry more channels than wq (padded_channels of them): those meet zero
    weights. `packed` and `packed_taps` are pack_weight(wq, dilation, xq's
    channels) without and with `taps` (the gather mode's operand and the
    TMA modes'), each made here where it is needed and not given. The
    kernel's tile and A mode are launch_config's choice."""
    return _conv_s8(xq, wq, scale, stride=stride, padding=padding,
                    dilation=dilation, out_dtype=out_dtype, packed=packed,
                    packed_taps=packed_taps)


def _conv_s8(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, *,
             stride: int = 1, padding: int = 1, dilation: int = 1,
             out_dtype: torch.dtype = torch.bfloat16,
             packed: Optional[torch.Tensor] = None,
             packed_taps: Optional[torch.Tensor] = None,
             tile_m: Optional[int] = None,
             mode: Optional[str] = None) -> torch.Tensor:
    """conv_s8 with the kernel's output-pixel tile and A mode forced where
    given (launch_config): the card tests' and tools/conv_s8_sweep.py's
    way to reach each of the kernel's paths at any shape."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"conv_s8: int8 operands, got {xq.dtype}, "
                        f"{wq.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv_s8: output bf16 or fp32, got {out_dtype}")
    if xq.ndim != 4 or wq.ndim != 4 or \
            xq.shape[1] not in (wq.shape[1], padded_channels(wq.shape[1])):
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
    if cin % 16 or xq.data_ptr() % 16:
        raise ValueError(f"conv_s8: the activation's channels ({cin}) must "
                         f"be a multiple of 16 and its data 16-byte aligned "
                         f"(quantize_s8 pads them)")
    if dilation == 2 and (kh, kw, stride, padding) != (4, 4, 1, 2):
        raise ValueError("conv_s8: the lhs-dilated conv is the 4x4 up-conv "
                         "(stride 1, padding 2) only")
    phases, kpad, bn, cout_pad = _gemm_shape(cout, cin, kh, kw, dilation)
    ho = out_size(h, kh, stride, padding, dilation)
    wo = out_size(w, kw, stride, padding, dilation)
    dev = xq.get_device()
    tile_m, mode = launch_config(n, h, w, cout, kh, kw, stride, padding,
                                 dilation, _sm_count(dev), tile_m, mode)
    if mode != "gather":
        if packed_taps is None:
            packed_taps = pack_weight(wq, dilation, cin, taps=True)
        packed = packed_taps
        c, t = tma_chunk(cin), 2 if dilation == 2 else 3
        want = (phases, -(-cin // c), t, t, cout_pad, c)
    else:
        if packed is None:
            packed = pack_weight(wq, dilation, cin)
        want = (phases, kpad // K_STEP, cout_pad, K_STEP)
    if scale.dtype != torch.float32 or scale.get_device() != dev or \
            not scale.is_contiguous():
        scale = scale.to(device=xq.device, dtype=torch.float32).contiguous()
    if packed.get_device() != dev or packed.dtype != torch.int8 or \
            not packed.is_contiguous() or scale.numel() != cout or \
            packed.shape != want:
        raise ValueError("conv_s8: packed weight or scale does not fit")
    y = torch.empty((n, cout, ho, wo), dtype=out_dtype, device=xq.device,
                    memory_format=torch.channels_last)
    if y.numel():
        if dev != torch._C._cuda_getDevice():
            with torch.cuda.device(dev):
                return _conv_s8(xq, wq, scale, stride=stride,
                                padding=padding, dilation=dilation,
                                out_dtype=out_dtype, packed=packed,
                                packed_taps=packed_taps, tile_m=tile_m,
                                mode=mode)
        lib = _lib()
        rc = lib.uwt_conv_s8(
            xq.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
            n, h, w, cin, ho, wo, cout, kh, kw, stride, padding, dilation,
            cout_pad, bn, tile_m, MODES.index(mode),
            int(out_dtype == torch.bfloat16),
            torch._C._cuda_getCurrentRawStream(dev))
        _raise_on(lib, rc, "conv_s8")
        _conv_wrapper.launches += 1
    return y


# the wrappers themselves, whose counts a caller that wraps the module's
# functions (chip_smoke.py holds each launch against the plain version so)
# still reads
_conv_wrapper, _quantize_wrapper = conv_s8, quantize_s8
conv_s8.launches = 0
quantize_s8.launches = 0


def reset_launch_counts() -> None:
    _conv_wrapper.launches = 0
    _quantize_wrapper.launches = 0
