"""Tokenizer protocol and the deterministic stand-in tokenizer.

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
from typing import List, Protocol

from .constants import BOS_TOKEN_ID, EMPTY_TOKEN_ID


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
