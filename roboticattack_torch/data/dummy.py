"""Synthetic frame source: random images + instructions + normalized actions.

The same numpy draws, in the same order, as the JAX package's
`data/dummy.py`, so one seed gives bit-identical frames in both packages.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from ..utils.prompting import TextTokenizer, build_vla_example

_INSTRUCTIONS = (
    "pick up the red bowl",
    "put the spoon on the towel",
    "close the microwave",
    "move the pot to the left burner",
    "open the top drawer",
    "stack the green block on the yellow block",
    "push the plate to the front of the table",
    "turn on the stove",
)


def dummy_frame_iterator(
    tokenizer: TextTokenizer,
    image_size: int = 224,
    seed: int = 42,
    gripper_open_prob: float = 0.5,
) -> Iterator[Dict]:
    """Infinite stream of synthetic frames (image uint8 HWC, tokenized prompt,
    masked labels)."""
    rng = np.random.default_rng(seed)
    while True:
        action = rng.uniform(-1.0, 1.0, size=7)
        # gripper mostly saturated open/close
        action[6] = 1.0 if rng.uniform() < gripper_open_prob else -1.0
        instruction = _INSTRUCTIONS[rng.integers(len(_INSTRUCTIONS))]
        image = rng.integers(0, 256, size=(image_size, image_size, 3), dtype=np.uint8)
        input_ids, labels = build_vla_example(instruction, action, tokenizer)
        yield dict(
            image=image,
            input_ids=input_ids,
            labels=labels,
            instruction=instruction,
            dataset_name="dummy",
        )
