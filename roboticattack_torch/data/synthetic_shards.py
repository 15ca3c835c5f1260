"""Synthetic RLDS TFRecord layouts (bridge-orig schema) for tests and benches.

The port's own writer: the TFRecord framing and the `tf.Example` wire
encoding are written here, so shards can be made on a machine without
TensorFlow. The same numpy draws in the same order as the JAX package's
`data/synthetic_shards.py`, and PIL encodes the JPEGs in both, so one `rng`
gives the same episodes.

One writer for the episode proto schema every file layer parses
('steps/observation/<image_key>' repeated JPEG bytes,
'steps/observation/state' [T*8] floats, 'steps/action' [T*action_dim] floats,
'steps/language_instruction' repeated bytes) plus the TFDS on-disk directory
layout (<root>/<name>/<version>/<name>-train.tfrecord-... + dataset_info.json
with per-shard lengths).

A record is `u64 length | u32 masked CRC32C(length) | payload | u32 masked
CRC32C(payload)`, little-endian. The Example's feature map is written in key
order, as protobuf's deterministic serialization writes it; TensorFlow's
default serialization orders map entries by a hash seeded per process, so
its bytes for the same Example can differ from run to run.
"""

from __future__ import annotations

import io
import json
import os
import struct
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def _crc32c_table() -> Tuple[int, ...]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    c, table = 0xFFFFFFFF, _CRC32C_TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rotate right by 15 bits, add 0xa282ead8."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord_frame(payload: bytes) -> bytes:
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", masked_crc32c(length)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def encode_example(features: Dict[str, Tuple[str, Sequence]]) -> bytes:
    """{key: ("bytes", [bytes, ...]) | ("float", values)} -> the serialized
    tf.train.Example, map entries in key order. BytesList and FloatList both
    hold their values in field 1, floats packed as little-endian float32; a
    Feature holds a BytesList in field 1 and a FloatList in field 2."""
    entries = []
    for key in sorted(features):
        kind, values = features[key]
        if kind == "bytes":
            feature = _field(1, b"".join(_field(1, v) for v in values))
        elif kind == "float":
            feature = _field(2, _field(1, np.asarray(values, "<f4").tobytes()))
        else:
            raise ValueError(f"unknown feature kind {kind!r} for {key!r}")
        entries.append(_field(1, _field(1, key.encode()) + _field(2, feature)))
    return _field(1, b"".join(entries))


def jpeg_bytes(rng: np.random.Generator, size: int = 32) -> bytes:
    from PIL import Image

    arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def write_episode_tfrecord(
    path,
    n_episodes: int = 3,
    steps: int = 6,
    action_dim: int = 7,
    rng: Optional[np.random.Generator] = None,
    image_key: str = "image",
    image_size: int = 32,
    language: bytes = b"lift the block",
) -> None:
    """Write one TFRecord shard of RLDS episodes in the bridge schema."""
    rng = rng if rng is not None else np.random.default_rng(1)
    with open(str(path), "wb") as w:
        for _ in range(n_episodes):
            actions = rng.standard_normal((steps, action_dim)).astype(np.float32)
            actions[:, -1] = rng.uniform(-1, 1, steps)
            images = [jpeg_bytes(rng, image_size) for _ in range(steps)]
            state = rng.standard_normal(steps * 8).astype(np.float32)
            w.write(tfrecord_frame(encode_example({
                f"steps/observation/{image_key}": ("bytes", images),
                "steps/observation/state": ("float", state),
                "steps/action": ("float", actions.reshape(-1)),
                "steps/language_instruction": ("bytes", [language] * steps),
            })))


def write_rlds_layout(
    root,
    name: str = "bridge_orig",
    n_episodes: int = 4,
    steps: int = 6,
    image_key: str = "image_0",
    image_size: int = 32,
    n_shards: int = 1,
    with_info: bool = True,
    rng: Optional[np.random.Generator] = None,
    language: bytes = b"lift the block",
) -> str:
    """TFDS on-disk layout under <root>/<name>/1.0.0/; returns the version dir."""
    d = os.path.join(str(root), name, "1.0.0")
    os.makedirs(d, exist_ok=True)
    rng = rng if rng is not None else np.random.default_rng(0)
    per = n_episodes // n_shards
    for s in range(n_shards):
        write_episode_tfrecord(
            os.path.join(d, f"{name}-train.tfrecord-{s:05d}-of-{n_shards:05d}"),
            n_episodes=per, steps=steps, rng=rng, image_key=image_key,
            image_size=image_size, language=language,
        )
    if with_info:
        with open(os.path.join(d, "dataset_info.json"), "w") as f:
            json.dump({
                "name": name,
                "splits": [{"name": "train", "shardLengths": [str(per)] * n_shards}],
            }, f)
    return d
