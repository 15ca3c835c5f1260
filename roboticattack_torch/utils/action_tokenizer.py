"""Uniform-bin action token codec (numpy and torch).

256 uniform bins over [-1, 1] map onto the last 256 tokens of the 32000-entry
Llama vocab: an action encodes as ``vocab - digitize(action, bins)``, and a
token decodes through the 255 bin centers as
``centers[clip(vocab - id - 1, 0, 254)]``.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import N_ACTION_BINS, VOCAB_SIZE

# Static bin geometry (float64 on host; cast on device as needed).
BINS = np.linspace(-1.0, 1.0, N_ACTION_BINS)
BIN_CENTERS = (BINS[:-1] + BINS[1:]) / 2.0


def decode_tokens(token_ids: torch.Tensor, vocab_size: int = VOCAB_SIZE) -> torch.Tensor:
    """Token ids -> continuous actions (float32 bin centers), incl. the
    terminal clip."""
    discretized = torch.clamp(vocab_size - token_ids - 1, 0, BIN_CENTERS.shape[0] - 1)
    centers = torch.as_tensor(BIN_CENTERS, dtype=torch.float32, device=token_ids.device)
    return centers[discretized.long()]


def encode_actions_np(actions: np.ndarray, vocab_size: int = VOCAB_SIZE) -> np.ndarray:
    """Continuous actions -> token ids: ``vocab_size - digitize(clip(a), bins)``."""
    actions = np.clip(actions, -1.0, 1.0)
    return (vocab_size - np.digitize(actions, BINS)).astype(np.int64)


def decode_tokens_np(token_ids: np.ndarray, vocab_size: int = VOCAB_SIZE) -> np.ndarray:
    discretized = vocab_size - np.asarray(token_ids)
    discretized = np.clip(discretized - 1, 0, BIN_CENTERS.shape[0] - 1)
    return BIN_CENTERS[discretized]
