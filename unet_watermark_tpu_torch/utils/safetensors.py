"""A reader of the safetensors format (the card's machine has no
safetensors package): an 8-byte little-endian header length, a JSON header
naming each tensor's dtype, shape and byte range, then the raw bytes.
Tensors come back as numpy arrays (bfloat16 widened to float32)."""
from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np

DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
          "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
          "U8": np.uint8, "BOOL": np.bool_}


def _array(buf: bytes, dtype: str, shape) -> np.ndarray:
    if dtype == "BF16":
        half = np.frombuffer(buf, "<u2").astype(np.uint32) << 16
        return half.view(np.float32).reshape(shape)
    if dtype not in DTYPES:
        raise ValueError(f"safetensors dtype {dtype} is not read here")
    return np.frombuffer(buf, np.dtype(DTYPES[dtype]).newbyteorder("<")
                         ).reshape(shape).copy()


def load(path) -> Dict[str, np.ndarray]:
    """{name: array} of a .safetensors file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header runs past the file")
    header = json.loads(data[8:8 + n])
    body = data[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if not 0 <= begin <= end <= len(body):
            raise ValueError(f"{path}: {name} runs past the file")
        out[name] = _array(body[begin:end], info["dtype"], info["shape"])
    return out
