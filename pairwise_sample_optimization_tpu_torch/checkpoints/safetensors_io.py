"""The safetensors file format, written and read with the stdlib and torch.

A file is an 8-byte little-endian header length N, N bytes of a JSON
header and the raw tensor bytes. The header maps each tensor's name to
``{"dtype": "F32", "shape": [...], "data_offsets": [begin, end]}`` (byte
offsets into the data that follows the header) and may hold a
``"__metadata__"`` map of strings (read past; the writer writes none); the
writer pads it with spaces to a multiple of 8 bytes. Tensors are stored contiguous, little-endian, in the
order of their offsets, with no gap.

The port keeps its own copy because the ``safetensors`` package is not
among its dependencies; files it writes read back through that package.
"""

from __future__ import annotations

import json
import struct
import sys
from typing import Dict

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
          "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_CODES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 2**20  # a bound on the header's size, as the package's reader has


def _raw(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (name -> tensor, any device; copied to the CPU and
    made contiguous) to ``path``, in name order."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors files are little-endian")
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in _CODES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors code")
        data = _raw(t)
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for data in blobs:
            f.write(data)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of the safetensors file at ``path``, as CPU tensors of
    their stored dtype and shape."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors files are little-endian")
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file ({len(data)} bytes)")
    (n,) = struct.unpack("<Q", data[:8])
    if n > min(_MAX_HEADER, len(data) - 8):
        raise ValueError(f"{path}: header length {n} past the file's {len(data)} bytes")
    header = json.loads(data[8:8 + n])
    header.pop("__metadata__", None)
    start, end_of_data = 8 + n, len(data) - 8 - n
    out, spans = {}, []
    for name, info in header.items():
        dtype = DTYPES[info["dtype"]]
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(x) for x in info["data_offsets"])
        count = 1
        for s in shape:
            count *= s
        if not 0 <= begin <= end <= end_of_data or end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: {name} has offsets {begin}..{end} for {shape} {dtype}")
        spans.append((begin, end))
        raw = bytearray(data[start + begin:start + end])
        flat = (torch.frombuffer(raw, dtype=torch.uint8) if raw
                else torch.empty(0, dtype=torch.uint8))
        out[name] = flat.view(dtype).reshape(shape).clone()
    covered = 0
    for begin, end in sorted(spans):
        if begin != covered:
            raise ValueError(f"{path}: tensor data is not contiguous at byte {begin}")
        covered = end
    if covered != end_of_data:
        raise ValueError(f"{path}: {end_of_data - covered} bytes after the last tensor")
    return out
