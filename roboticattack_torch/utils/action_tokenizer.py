"""Uniform-bin action token codec (numpy and torch).

256 uniform bins over [-1, 1] map onto the last 256 tokens of the 32000-entry
Llama vocab: an action encodes as ``vocab - digitize(action, bins)``, and a
token decodes through the 255 bin centers as
``centers[clip(vocab - id - 1, 0, 254)]``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .constants import N_ACTION_BINS, VOCAB_SIZE

# Static bin geometry (float64 on host; cast on device as needed).
BINS = np.linspace(-1.0, 1.0, N_ACTION_BINS)
BIN_CENTERS = (BINS[:-1] + BINS[1:]) / 2.0


@functools.lru_cache(maxsize=None)
def _bin_centers(device: torch.device) -> torch.Tensor:
    """BIN_CENTERS as float32 on `device`, copied there once (a host copy
    waits for the device, and a CUDA graph's capture refuses one)."""
    return torch.as_tensor(BIN_CENTERS, dtype=torch.float32, device=device)


def decode_tokens(token_ids: torch.Tensor, vocab_size: int = VOCAB_SIZE) -> torch.Tensor:
    """Token ids -> continuous actions (float32 bin centers), incl. the
    terminal clip."""
    discretized = torch.clamp(vocab_size - token_ids - 1, 0, BIN_CENTERS.shape[0] - 1)
    return _bin_centers(token_ids.device)[discretized.long()]


def encode_actions(actions: torch.Tensor, vocab_size: int = VOCAB_SIZE) -> torch.Tensor:
    """Continuous actions in [-1, 1] -> int32 token ids in [31744, 31999]:
    ``vocab_size - searchsorted(bins, clip(a), side='right')``, which is
    ``np.digitize`` for increasing bins."""
    actions = torch.clamp(actions, -1.0, 1.0)
    bins = torch.as_tensor(BINS, dtype=actions.dtype, device=actions.device)
    return (vocab_size - torch.searchsorted(bins, actions.contiguous(), right=True)).to(torch.int32)


def encode_actions_np(actions: np.ndarray, vocab_size: int = VOCAB_SIZE) -> np.ndarray:
    """Continuous actions -> token ids: ``vocab_size - digitize(clip(a), bins)``."""
    actions = np.clip(actions, -1.0, 1.0)
    return (vocab_size - np.digitize(actions, BINS)).astype(np.int64)


def decode_tokens_np(token_ids: np.ndarray, vocab_size: int = VOCAB_SIZE) -> np.ndarray:
    discretized = vocab_size - np.asarray(token_ids)
    discretized = np.clip(discretized - 1, 0, BIN_CENTERS.shape[0] - 1)
    return BIN_CENTERS[discretized]


def action_token_string(actions: np.ndarray) -> str:
    """The action token ids as text, space-separated (a debugging aid)."""
    return " ".join(str(int(t)) for t in encode_actions_np(np.asarray(actions)))
