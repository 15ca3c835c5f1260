"""Batch collation: frame dicts -> dense numpy `AttackBatch` arrays.

Right-pads ids with the PAD token and labels with IGNORE (to `pad_to` when
given, so every batch has one shape), truncates to the model's max length,
sets attention mask = (ids != pad), and scales the uint8 images to [0, 1]
float32. The runner moves the arrays to the device.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from ..attacks.engine import AttackBatch
from ..utils.constants import IGNORE_INDEX, PAD_TOKEN_ID
from ..utils.prompting import pad_batch


def collate(
    frames: List[Dict],
    pad_to: Optional[int] = None,
    model_max_length: int = 2048,
) -> AttackBatch:
    ids = [f["input_ids"] for f in frames]
    labels = [f["labels"] for f in frames]
    if pad_to is not None:
        longest = max(len(s) for s in ids)
        if longest > pad_to:
            raise ValueError(f"sequence {longest} exceeds pad_to={pad_to}")
        ids = [np.concatenate([s, np.full(pad_to - len(s), PAD_TOKEN_ID, np.int32)]) for s in ids]
        labels = [
            np.concatenate([s, np.full(pad_to - len(s), IGNORE_INDEX, np.int32)]) for s in labels
        ]
    input_ids = pad_batch(ids, PAD_TOKEN_ID, max_length=model_max_length)
    label_arr = pad_batch(labels, IGNORE_INDEX, max_length=model_max_length)
    attention_mask = (input_ids != PAD_TOKEN_ID).astype(np.int32)
    images = np.stack([f["image"] for f in frames]).astype(np.float32) / 255.0
    return AttackBatch(
        images=images,
        input_ids=input_ids,
        attention_mask=attention_mask,
        labels=label_arr,
    )


def batch_iterator(
    frame_iter: Iterator[Dict],
    batch_size: int,
    pad_to: Optional[int] = 64,
) -> Iterator[AttackBatch]:
    while True:
        yield collate([next(frame_iter) for _ in range(batch_size)], pad_to=pad_to)
