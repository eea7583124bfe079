"""The ``.safetensors`` format, read and written without the ``safetensors``
package: an 8-byte little-endian header length N, N bytes of JSON mapping
each name to its dtype, shape and [begin, end) byte offsets into the data
that follows, then the raw little-endian data with no holes. A
``__metadata__`` entry holds string pairs.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Optional

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32}
NAMES = {v: k for k, v in DTYPES.items()}


def read_header(path: str) -> Dict[str, dict]:
    """The JSON header: name -> {"dtype", "shape", "data_offsets"}, and
    ``__metadata__`` if the file has one."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n))


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, on the CPU, each with its own storage."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = end - begin
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for s in shape:
            numel *= s
        if count != numel * itemsize or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} does not match its "
                             f"offsets [{begin}, {end})")
        raw = torch.frombuffer(data, dtype=torch.uint8, count=count, offset=begin) \
            if count else torch.empty(0, dtype=torch.uint8)
        out[name] = raw.clone().view(dtype).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (each moved to the CPU in turn), the widest dtypes
    first so that every tensor starts on a multiple of its item size."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}, not one of "
                             f"{sorted(DTYPES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous()
            f.write(t.reshape(-1).view(torch.uint8).numpy().data)
