"""VLM pretraining preprocessing: LLaVA-style align/finetune datasets (the
JAX package's `training/preprocessing.py`).

Equivalent of prismatic/preprocessing/ (+ util/batching_utils.py's
SplitModalitySampler): json-driven conversation datasets for the align and
finetune stages of Prismatic VLM training, and a batching sampler that groups
examples by modality so multimodal and text-only examples don't share a batch
(padding-efficiency trick, batching_utils.py:23+).

Records follow the LLaVA json schema:
  {"id": ..., "image": "rel/path.jpg" (optional),
   "conversations": [{"from": "human"|"gpt", "value": "..."}, ...]}
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Type

import numpy as np

from ..utils.constants import IGNORE_INDEX
from ..utils.prompting import PurePromptBuilder, TextTokenizer


@dataclass
class ConversationDataset:
    """Align/finetune dataset: conversations -> (input_ids, labels, image).

    Align stage (`align=True`) mirrors AlignDataset: only the image-caption
    pair is kept (first gpt turn), with the human turn reduced to the image
    placeholder. Finetune keeps all turns; human-turn tokens are IGNOREd.
    """

    json_path: str
    image_root: str
    tokenizer: TextTokenizer
    prompt_builder_cls: Type = PurePromptBuilder
    align: bool = False
    image_size: int = 224

    def __post_init__(self):
        with open(self.json_path) as f:
            self.records: List[Dict] = json.load(f)

    def __len__(self) -> int:
        return len(self.records)

    def get_modality_lengths(self) -> List[tuple]:
        """(is_multimodal, approx_token_length) per record — the sampler key
        (batching_utils.py contract)."""
        out = []
        for rec in self.records:
            n = sum(len(turn["value"].split()) for turn in rec["conversations"])
            out.append(("image" in rec, n))
        return out

    def _load_image(self, rel_path: str) -> np.ndarray:
        from PIL import Image

        pil = Image.open(os.path.join(self.image_root, rel_path)).convert("RGB")
        pil = pil.resize((self.image_size, self.image_size), Image.BICUBIC)
        return np.asarray(pil, np.uint8)

    def __getitem__(self, idx: int) -> Dict:
        rec = self.records[idx]
        builder = self.prompt_builder_cls("openvla")
        convo = rec["conversations"]
        if self.align:
            # align stage: caption-only supervision
            convo = [
                {"from": "human", "value": "<image>"},
                next(t for t in convo if t["from"] == "gpt"),
            ]
        input_ids: List[int] = []
        labels: List[int] = []
        for i, turn in enumerate(convo):
            role = "human" if turn["from"] == "human" else "gpt"
            wrapped = builder.add_turn(role, turn["value"])
            if i == 0 and wrapped.startswith(builder.bos):
                # the tokenizer re-adds BOS (add_bos=True); strip a
                # builder-embedded literal one (e.g. PhiPromptBuilder)
                wrapped = wrapped.removeprefix(builder.bos)
            ids = self.tokenizer.encode(wrapped, add_bos=(i == 0))
            input_ids.extend(ids)
            labels.extend(ids if role == "gpt" else [IGNORE_INDEX] * len(ids))
        out = {
            "input_ids": np.asarray(input_ids, np.int32),
            "labels": np.asarray(labels, np.int32),
        }
        if "image" in rec:
            out["image"] = self._load_image(rec["image"])
        return out


class SplitModalitySampler:
    """Groups example indices so each batch is single-modality, batches sorted
    by length within modality for padding efficiency, batch order shuffled
    (util/batching_utils.py:23+ behavior at our simplification level)."""

    def __init__(self, modality_lengths: Sequence[tuple], batch_size: int, seed: int = 0):
        self.modality_lengths = list(modality_lengths)
        self.batch_size = batch_size
        self.seed = seed

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed)
        mm = [i for i, (is_mm, _) in enumerate(self.modality_lengths) if is_mm]
        uni = [i for i, (is_mm, _) in enumerate(self.modality_lengths) if not is_mm]
        batches: List[List[int]] = []
        for group in (mm, uni):
            group = sorted(group, key=lambda i: self.modality_lengths[i][1])
            for s in range(0, len(group), self.batch_size):
                chunk = group[s : s + self.batch_size]
                if len(chunk) == self.batch_size:
                    batches.append(chunk)
        order = rng.permutation(len(batches))
        for b in order:
            yield batches[b]

    def __len__(self) -> int:
        mm = sum(1 for is_mm, _ in self.modality_lengths if is_mm)
        uni = len(self.modality_lengths) - mm
        return mm // self.batch_size + uni // self.batch_size
