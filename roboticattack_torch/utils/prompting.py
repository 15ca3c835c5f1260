"""Tokenizer protocol, the deterministic stand-in tokenizer, and the
attack's training examples.

No Llama SentencePiece model ships with the repository, so text tokenization
is an injected dependency (`TextTokenizer`). `WordStubTokenizer` is the
deterministic hash-based stand-in for random-weight serving and tests: it
gives the same ids as the JAX package's (sha1 is deterministic) and keeps the
properties the decode relies on (BOS first, text ids below the action range,
trailing EMPTY_TOKEN_ID after "Out:").
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional, Protocol, Sequence

import numpy as np

from .action_tokenizer import encode_actions_np
from .constants import BOS_TOKEN_ID, EMPTY_TOKEN_ID, EOS_TOKEN_ID, IGNORE_INDEX


class TextTokenizer(Protocol):
    def encode(self, text: str, add_bos: bool = True) -> List[int]: ...


@dataclass
class WordStubTokenizer:
    """Deterministic hash tokenizer for random-weight serving and tests.

    Splits on whitespace; each word maps stably into [100, text_vocab_limit).
    Emits BOS first and EMPTY_TOKEN_ID for a trailing bare space or colon
    (mimicking SentencePiece's behavior after "Out: ").
    """

    text_vocab_limit: int = 31000
    _cache: dict = field(default_factory=dict)

    def _word_id(self, word: str) -> int:
        if word not in self._cache:
            h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
            self._cache[word] = 100 + h % (self.text_vocab_limit - 100)
        return self._cache[word]

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids: List[int] = [BOS_TOKEN_ID] if add_bos else []
        trailing_space = text.endswith(" ")
        for word in text.split():
            ids.append(self._word_id(word))
        if trailing_space or text.endswith(":"):
            ids.append(EMPTY_TOKEN_ID)
        return ids


def vla_prompt(instruction: str) -> str:
    """The single-turn human prompt of the attack and eval paths."""
    return f"What action should the robot take to {instruction.lower()}?"


def build_vla_example(
    instruction: str,
    action: np.ndarray,
    tokenizer: TextTokenizer,
    predict_stop_token: bool = True,
):
    """Tokenized (input_ids, labels) int32 for one frame: [BOS] <prompt>
    <7 action tokens> [EOS], labels IGNORE but for the last action_dim + 1
    tokens. The prompt is the "In: {msg}\\nOut: " turn of the pure prompt
    builder; action ids are arithmetic (utils/action_tokenizer.py)."""
    action = np.asarray(action, dtype=np.float64)
    prompt_text = f"In: {vla_prompt(instruction).replace('<image>', '').strip()}\nOut: "
    prompt_ids = tokenizer.encode(prompt_text, add_bos=True)
    input_ids = prompt_ids + encode_actions_np(action).tolist() + [EOS_TOKEN_ID]

    labels = np.asarray(input_ids, dtype=np.int32).copy()
    labels[: -(action.shape[0] + 1)] = IGNORE_INDEX
    if not predict_stop_token:
        labels[-1] = IGNORE_INDEX
    return np.asarray(input_ids, dtype=np.int32), labels


def pad_batch(
    sequences: Sequence[np.ndarray],
    pad_value: int,
    max_length: Optional[int] = None,
) -> np.ndarray:
    """Right-pad variable-length id sequences into a dense int32 [B, L]
    array, truncated to max_length."""
    longest = max(len(s) for s in sequences)
    length = longest if max_length is None else min(longest, max_length)
    out = np.full((len(sequences), length), pad_value, dtype=np.int32)
    for i, seq in enumerate(sequences):
        seq = np.asarray(seq)[:length]
        out[i, : len(seq)] = seq
    return out
