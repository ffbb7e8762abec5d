"""A reader of the safetensors format, without the `safetensors` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
mapping each tensor's name to {"dtype", "shape", "data_offsets": [begin,
end]} (plus an optional "__metadata__" entry of strings), then the tensors'
raw little-endian bytes, offsets counted from the end of the header.

`load_file` maps the file copy-on-write and returns tensors that are views
of the mapping (torch.frombuffer): nothing is read until a tensor is used,
so a 16 GB shard is never copied whole into host memory, and each tensor
can be copied to the device, and cast there, one at a time. Writing to a
returned tensor never changes the file.
"""

from __future__ import annotations

import json
import mmap
import struct
import sys
from math import prod
from pathlib import Path
from typing import Dict

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
# the header's own length limit in the reference implementation (100 MB)
MAX_HEADER = 100_000_000


class SafetensorsError(ValueError):
    pass


def read_header(path: str | Path) -> tuple[dict, int, int]:
    """(tensor entries without "__metadata__", byte offset of the data,
    data length), every entry checked: a known dtype, a shape of
    non-negative ints, offsets inside the data whose length is the shape's,
    and no two tensors overlapping."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise SafetensorsError(f"{path}: truncated (no header length)")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER or 8 + n > size:
            raise SafetensorsError(f"{path}: truncated or corrupt (header of "
                                   f"{n} bytes in a file of {size})")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise SafetensorsError(f"{path}: header is not JSON ({e})") from None
    if not isinstance(header, dict):
        raise SafetensorsError(f"{path}: header is not a JSON object")
    header.pop("__metadata__", None)
    data_len = size - 8 - n
    spans = []
    for name, e in header.items():
        dtype = DTYPES.get(e.get("dtype")) if isinstance(e, dict) else None
        if dtype is None:
            raise SafetensorsError(f"{path}: {name}: unsupported dtype "
                                   f"{e.get('dtype') if isinstance(e, dict) else e!r}")
        shape, offs = e.get("shape"), e.get("data_offsets")
        if (not isinstance(shape, list)
                or not all(isinstance(d, int) and d >= 0 for d in shape)
                or not isinstance(offs, list) or len(offs) != 2
                or not all(isinstance(o, int) for o in offs)):
            raise SafetensorsError(f"{path}: {name}: malformed entry {e}")
        begin, end = offs
        nbytes = prod(shape) * dtype.itemsize
        if not 0 <= begin <= end or end - begin != nbytes:
            raise SafetensorsError(f"{path}: {name}: offsets {offs} do not "
                                   f"hold {shape} of {e['dtype']}")
        if end > data_len:
            raise SafetensorsError(f"{path}: {name}: offsets {offs} run past "
                                   f"the end of the data ({data_len} bytes): "
                                   "truncated file")
        spans.append((begin, end, name))
    reach, last = 0, None  # the furthest end so far, and whose it is
    for begin, end, name in sorted(s for s in spans if s[1] > s[0]):
        if begin < reach:
            raise SafetensorsError(f"{path}: {last} and {name} overlap")
        reach, last = end, name
    return header, 8 + n, data_len


def load_file(path: str | Path) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, in the header's order, as CPU tensors of
    the stored dtype that view a copy-on-write mapping of the file."""
    if sys.byteorder != "little":
        raise SafetensorsError("safetensors data is little-endian; this "
                               "host is not")
    header, start, data_len = read_header(path)
    buf = None
    if data_len:
        with open(path, "rb") as f:
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, e in header.items():
        dtype, shape = DTYPES[e["dtype"]], e["shape"]
        begin, end = e["data_offsets"]
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        t = torch.frombuffer(buf, dtype=dtype, count=(end - begin) // dtype.itemsize,
                             offset=start + begin).reshape(shape)
        # a tensor that is not aligned to its element size gets its own
        # storage (kernels may assume the alignment)
        out[name] = t if (start + begin) % dtype.itemsize == 0 else t.clone()
    return out
