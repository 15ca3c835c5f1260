"""The benchmark's own inputs, drawn from `--seed`: camera frames, task
instructions, action labels and the patch's random placements and warps.

The arithmetic copies the program's synthetic data source (a frame is a
uniform action in [-1, 1]^7 with a saturated gripper, an instruction from a
fixed list and a uniform uint8 image; the prompt is tokenized word by word
through a sha1 hash) and its patch draws (placement, then a rescale coin,
then an affine matrix: identity with probability 0.2, else shear @ rotation).
Nothing here imports the program: both sides get the same arrays.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, NamedTuple

import numpy as np
import torch

BOS, EOS, EMPTY, PAD, IGNORE = 1, 2, 29871, 32000, -100
ACTION_VOCAB = 32000  # action token = ACTION_VOCAB - digitize(action, BINS)
BINS = np.linspace(-1.0, 1.0, 256)
TEXT_VOCAB_LIMIT = 31000  # word ids lie in [100, 31000): below the action tokens

INSTRUCTIONS = (
    "pick up the red bowl",
    "put the spoon on the towel",
    "close the microwave",
    "move the pot to the left burner",
    "open the top drawer",
    "stack the green block on the yellow block",
    "push the plate to the front of the table",
    "turn on the stove",
)


def word_id(word: str) -> int:
    h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
    return 100 + h % (TEXT_VOCAB_LIMIT - 100)


def encode_prompt(instruction: str) -> List[int]:
    """BOS, one id a word of "In: What action should the robot take to
    <instruction>?\\nOut: ", and EMPTY for the trailing space."""
    text = f"In: What action should the robot take to {instruction.lower()}?\nOut: "
    return [BOS] + [word_id(w) for w in text.split()] + [EMPTY]


def action_tokens(action: np.ndarray) -> np.ndarray:
    return (ACTION_VOCAB - np.digitize(np.clip(action, -1.0, 1.0), BINS)).astype(np.int64)


def example(instruction: str, action: np.ndarray):
    """(input_ids, labels): the prompt, 7 action tokens and EOS; labels are
    IGNORE but on the action tokens and EOS."""
    ids = encode_prompt(instruction) + action_tokens(action).tolist() + [EOS]
    labels = np.asarray(ids, np.int64).copy()
    labels[: -(len(action) + 1)] = IGNORE
    return np.asarray(ids, np.int64), labels


def frames(seed: int, image_size: int) -> Iterator[Dict]:
    """An endless stream of frames, each one new: image uint8 [H, W, 3],
    instruction, input_ids and labels."""
    rng = np.random.default_rng(seed)
    while True:
        action = rng.uniform(-1.0, 1.0, size=7)
        action[6] = 1.0 if rng.uniform() < 0.5 else -1.0
        instruction = INSTRUCTIONS[rng.integers(len(INSTRUCTIONS))]
        image = rng.integers(0, 256, size=(image_size, image_size, 3), dtype=np.uint8)
        ids, labels = example(instruction, action)
        yield {"image": image, "instruction": instruction, "input_ids": ids, "labels": labels}


class Batch(NamedTuple):
    """Host arrays of one batch: images f32 [B, H, W, 3] in [0, 1], then
    input_ids, attention_mask and labels, int64 [B, pad_to]."""

    images: np.ndarray
    input_ids: np.ndarray
    attention_mask: np.ndarray
    labels: np.ndarray


def collate(rows: List[Dict], pad_to: int) -> Batch:
    n = max(len(r["input_ids"]) for r in rows)
    if n > pad_to:
        raise ValueError(f"a prompt of {n} tokens exceeds pad_to={pad_to}")
    ids = np.full((len(rows), pad_to), PAD, np.int64)
    labels = np.full((len(rows), pad_to), IGNORE, np.int64)
    for i, r in enumerate(rows):
        ids[i, : len(r["input_ids"])] = r["input_ids"]
        labels[i, : len(r["labels"])] = r["labels"]
    images = np.stack([r["image"] for r in rows]).astype(np.float32) / 255.0
    return Batch(images, ids, (ids != PAD).astype(np.int64), labels)


def batches(seed: int, image_size: int, batch_size: int, pad_to: int) -> Iterator[Batch]:
    """An endless stream of batches whose rows all differ."""
    it = frames(seed, image_size)
    while True:
        yield collate([next(it) for _ in range(batch_size)], pad_to)


class Draws(NamedTuple):
    """One inner step's patch draws: xy int64 [B, 2] (x, y) and the affine
    matrices f32 [B, 3, 3] (output -> input normalized coordinates)."""

    xy: torch.Tensor
    matrix: torch.Tensor
    scale: torch.Tensor


def _affine(u: torch.Tensor, max_angle: float = 30.0, max_shear: float = 0.2) -> torch.Tensor:
    """u [4] uniform: the identity coin, angle, shx, shy -> [3, 3]."""
    if float(u[0]) < 0.2:
        return torch.eye(3)
    theta = torch.deg2rad((2.0 * u[1] - 1.0) * max_angle)
    c, s = torch.cos(theta), torch.sin(theta)
    shx, shy = (2.0 * u[2] - 1.0) * max_shear, (2.0 * u[3] - 1.0) * max_shear
    rot = torch.stack([torch.stack([c, -s, torch.zeros(())]), torch.stack([s, c, torch.zeros(())]),
                       torch.tensor([0.0, 0.0, 1.0])])
    shear = torch.stack([torch.stack([torch.ones(()), shx, torch.zeros(())]),
                         torch.stack([shy, torch.ones(()), torch.zeros(())]),
                         torch.tensor([0.0, 0.0, 1.0])])
    return shear @ rot


def patch_draws(gen: torch.Generator, batch: int, size: int, patch: int) -> Draws:
    """A batch's draws on the CPU, per image: placement, rescale coin, warp."""
    xy, scale, mats = [], [], []
    for _ in range(batch):
        x = int(torch.randint(0, size - patch + 1, (), generator=gen))
        y = int(torch.randint(0, size - patch + 1, (), generator=gen))
        xy.append((x, y))
        scale.append(0.61 + 0.78 * float(torch.rand((), generator=gen)))
        mats.append(_affine(torch.rand((4,), generator=gen)))
    return Draws(torch.tensor(xy, dtype=torch.int64), torch.stack(mats).float(),
                 torch.tensor(scale, dtype=torch.float32))


def step_draws(seed: int, step: int, inner: int, batch: int, size: int, patch: int) -> List[Draws]:
    """The draws of outer step `step`: one Draws per inner step, from a
    generator seeded by (seed, step) as the attack runner seeds its own."""
    gen = torch.Generator().manual_seed(seed * 1000003 + step)
    return [patch_draws(gen, batch, size, patch) for _ in range(inner)]


def initial_patch(seed: int, patch: int) -> torch.Tensor:
    """The patch the attack starts from: U[0, 1) [patch, patch, 3] f32."""
    return torch.rand((patch, patch, 3), generator=torch.Generator().manual_seed(seed))
