"""The safetensors format, read and written with torch and numpy alone.

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}``, offsets relative to the end of the header), then the raw
little-endian tensor bytes. A sharded checkpoint is a directory of such
files with ``model.safetensors.index.json`` mapping each name to its file.

``read_safetensors`` maps each file into memory (copy-on-write) and hands
out tensors that view the mapping, so a shard's bytes are not copied on the
host: the page cache holds them, and a tensor moved to the card is copied
once, from there. The port needs no ``safetensors`` package.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "F8_E4M3": torch.float8_e4m3fn, "I8": torch.int8,
    "U8": torch.uint8, "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
INDEX = "model.safetensors.index.json"


def _files(path: str) -> list:
    """The safetensors files of a checkpoint: the file itself, the files the
    index names, or every ``*.safetensors`` of the directory."""
    if not os.path.isdir(path):
        return [path]
    index = os.path.join(path, INDEX)
    if os.path.exists(index):
        with open(index) as f:
            names = sorted(set(json.load(f)["weight_map"].values()))
    else:
        names = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not names:
        raise FileNotFoundError(f"no safetensors files in {path}")
    return [os.path.join(path, n) for n in names]


def _read_file(fn: str) -> Dict[str, torch.Tensor]:
    with open(fn, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else b""
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{fn}: {name} has dtype {info['dtype']}, not one of "
                             f"{sorted(DTYPES)}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{fn}: {name} spans {end - begin} bytes for shape {shape} "
                             f"of {info['dtype']}")
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin,
                               offset=base + begin)
        if (base + begin) % itemsize:
            raw = raw.clone()  # a misaligned tensor: one copy to view it
        out[name] = raw.view(dtype).reshape(shape)
    return out


def read_safetensors(path: str, device=None) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, or of a checkpoint directory
    (sharded through its index, or all its ``*.safetensors`` files), by
    name. Without ``device`` the tensors view the files' memory maps (no
    copy; write to them and only the process's pages change); with one they
    are copied there."""
    out: Dict[str, torch.Tensor] = {}
    for fn in _files(path):
        out.update(_read_file(fn))
    if device is not None:
        out = {k: v.to(device) for k, v in out.items()}
    return out


def _as_tensor(a: Union[torch.Tensor, np.ndarray]) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        if a.dtype.name == "bfloat16":  # ml_dtypes
            return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(
                torch.bfloat16)
        if a.dtype.name == "float8_e4m3fn":
            return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8)).view(
                torch.float8_e4m3fn)
        return torch.from_numpy(np.ascontiguousarray(a))
    return a.detach()


def write_safetensors(path: str, tensors: Mapping[str, Union[torch.Tensor, np.ndarray]],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (torch tensors, on any device, or numpy arrays) as
    one safetensors file; returns the bytes written. The data follow one
    another without gaps (the format allows none), the widest element types
    first, so every tensor starts aligned to its element size."""
    items = sorted(((k, _as_tensor(v)) for k, v in tensors.items()),
                   key=lambda kv: -kv[1].element_size())
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for k, t in items:
        if t.dtype not in _NAMES:
            raise ValueError(f"{k}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + nbytes]}
        off += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * ((-len(blob)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k, t in items:
            a = t.contiguous().cpu().reshape(-1)
            if a.numel():
                f.write(memoryview(a.view(torch.uint8).numpy()))
        return f.tell()


def write_checkpoint(path: str, tensors: Mapping[str, Union[torch.Tensor, np.ndarray]],
                     config: Optional[dict] = None, n_shards: int = 1) -> int:
    """A checkpoint directory: ``config.json`` (when given) and the tensors
    in ``n_shards`` files of about equal size, with
    ``model.safetensors.index.json`` when there are two or more (the
    ``model-0000i-of-0000n.safetensors`` names HF uses). Returns the tensor
    files' bytes."""
    os.makedirs(path, exist_ok=True)
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f, indent=1)
    if n_shards <= 1:
        return write_safetensors(os.path.join(path, "model.safetensors"), tensors)
    sizes = {k: _as_tensor(v).numel() * _as_tensor(v).element_size()
             for k, v in tensors.items()}
    per = -(-sum(sizes.values()) // n_shards)
    shards: list = [[]]
    acc = 0
    for k in tensors:
        if acc >= per * len(shards) and len(shards) < n_shards:
            shards.append([])
        shards[-1].append(k)
        acc += sizes[k]
    weight_map, total = {}, 0
    for i, keys in enumerate(shards):
        fn = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        total += write_safetensors(os.path.join(path, fn), {k: tensors[k] for k in keys})
        weight_map.update({k: fn for k in keys})
    with open(os.path.join(path, INDEX), "w") as f:
        json.dump({"metadata": {"total_size": sum(sizes.values())},
                   "weight_map": weight_map}, f, indent=1)
    return total
