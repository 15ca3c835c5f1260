"""A reader of HF safetensors checkpoints that needs neither the
`safetensors` package nor `ml_dtypes`.

A safetensors file is an 8-byte little-endian header length, a JSON header
mapping each tensor name to {dtype, shape, data_offsets: [begin, end]}
(offsets relative to the byte after the header), and the tensors' raw
little-endian bytes. The reader maps each file copy-on-write and returns
every tensor as a view of that map in its own dtype (bf16 included), bit
for bit and without a copy: moving a view to the card is the read.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Dict, List, Tuple

import torch

# safetensors dtype name -> torch dtype
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
INDEX_FILE = "model.safetensors.index.json"


def checkpoint_shard_files(path: str) -> List[str]:
    """Shard file names of a checkpoint directory: from the index when there
    is one (the released OpenVLA checkpoints ship one), else every
    `*.safetensors` file. A missing directory raises FileNotFoundError."""
    index_path = os.path.join(path, INDEX_FILE)
    if os.path.exists(index_path):
        with open(index_path) as f:
            return sorted(set(json.load(f)["weight_map"].values()))
    return sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))


def read_header(file: str) -> Tuple[Dict[str, dict], int]:
    """(header without `__metadata__`, byte offset of the data) of one file.
    Raises ValueError unless the tensors' byte ranges tile the data exactly,
    each as long as its dtype and shape say."""
    size = os.path.getsize(file)
    with open(file, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{file}: {size} bytes, too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{file}: header of {n} bytes runs past the end of the file")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    start = 8 + n
    end = 0
    for name, meta in sorted(header.items(), key=lambda kv: tuple(kv[1]["data_offsets"])):
        if meta["dtype"] not in DTYPES:
            raise ValueError(f"{file}: tensor {name!r} has dtype {meta['dtype']}, "
                             f"not one of {sorted(DTYPES)}")
        b, e = meta["data_offsets"]
        want = math.prod(meta["shape"]) * DTYPES[meta["dtype"]].itemsize
        if b != end or e - b != want:
            raise ValueError(f"{file}: tensor {name!r} holds bytes [{b}, {e}) where "
                             f"[{end}, {end + want}) is due: the header's byte ranges "
                             "do not cover the data")
        end = e
    if start + end != size:
        raise ValueError(f"{file}: the header covers {end} data bytes and the file "
                         f"holds {size - start}")
    return header, start


def read_safetensors_headers(path: str) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """{tensor name: (dtype, shape)} over every shard of a checkpoint
    directory, from the headers alone."""
    out: Dict[str, Tuple[str, Tuple[int, ...]]] = {}
    for shard in checkpoint_shard_files(path):
        header, _ = read_header(os.path.join(path, shard))
        out.update({k: (m["dtype"], tuple(m["shape"])) for k, m in header.items()})
    return out


def load_file(file: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of one file: CPU views of a copy-on-write map of it.
    Each view holds the map open; writing to one changes no file."""
    header, start = read_header(file)
    with open(file, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if header else None
    out = {}
    for name, meta in header.items():
        dtype, shape = DTYPES[meta["dtype"]], meta["shape"]
        b, e = meta["data_offsets"]
        if e == b:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=e - b, offset=start + b)
        out[name] = raw.view(dtype).reshape(shape)
    return out


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The raw {HF name: tensor} state of a checkpoint directory's shards,
    as views of the files (no conversion, no copy)."""
    shards = checkpoint_shard_files(path)
    if not shards:
        raise FileNotFoundError(f"no *.safetensors shards in {path}")
    state: Dict[str, torch.Tensor] = {}
    for shard in shards:
        state.update(load_file(os.path.join(path, shard)))
    return state
