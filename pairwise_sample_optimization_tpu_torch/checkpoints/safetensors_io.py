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
import math
import os
import struct
import sys
from typing import Dict

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
          "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_CODES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 2**20  # a bound on the header's size, as the package's reader has


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (name -> tensor, any device) to ``path``, in name
    order. The header is made from the tensors' shapes and dtypes, then each
    tensor is copied to the CPU and written on its own, so the host holds
    one tensor at a time."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors files are little-endian")
    header, offset = {}, 0
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in _CODES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors code")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in header:
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy())


def _read_exactly(f, buf: memoryview, path: str) -> None:
    got = 0
    while got < len(buf):
        n = f.readinto(buf[got:])
        if not n:
            raise ValueError(f"{path}: file ends inside tensor data")
        got += n


def load_file(path: str, device=None) -> Dict[str, torch.Tensor]:
    """The tensors of the safetensors file at ``path``, in their stored dtype
    and shape, on ``device`` (default the CPU).

    Each tensor is read from the file straight into its own storage (on the
    CPU) or into a host buffer of its size that is copied to ``device`` and
    dropped, so the process holds one copy of the data at most: the file is
    not mapped, and its pages are never part of the process."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors files are little-endian")
    device = torch.device(device or "cpu")
    file_size = os.path.getsize(path)
    with open(path, "rb", buffering=0) as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file ({file_size} bytes)")
        (n,) = struct.unpack("<Q", head)
        if n > min(_MAX_HEADER, file_size - 8):
            raise ValueError(f"{path}: header length {n} past the file's {file_size} bytes")
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        start, end_of_data = 8 + n, file_size - 8 - n
        entries = []
        for name, info in header.items():
            dtype = DTYPES[info["dtype"]]
            shape = [int(s) for s in info["shape"]]
            begin, end = (int(x) for x in info["data_offsets"])
            if not 0 <= begin <= end <= end_of_data or end - begin != math.prod(
                    shape) * dtype.itemsize:
                raise ValueError(f"{path}: {name} has offsets {begin}..{end} for {shape} {dtype}")
            entries.append((begin, end, name, dtype, shape))
        entries.sort()
        covered = 0
        for begin, end, *_ in entries:
            if begin != covered:
                raise ValueError(f"{path}: tensor data is not contiguous at byte {begin}")
            covered = end
        if covered != end_of_data:
            raise ValueError(f"{path}: {end_of_data - covered} bytes after the last tensor")
        out = {}
        f.seek(start)
        for begin, end, name, dtype, shape in entries:  # in file order: one sequential read
            t = torch.empty(shape, dtype=dtype)
            if t.numel():
                _read_exactly(f, memoryview(t.reshape(-1).view(torch.uint8).numpy()), path)
            out[name] = t if device.type == "cpu" else t.to(device)
    return out
