"""Prompt builders, the tokenizer protocol, the tokenizers, and the attack's
training examples.

The prompt builders give the reference's exact strings per LLM family
(prismatic/models/backbones/llm/prompting): the pure "In: ...\nOut: "
format of OpenVLA, Vicuna v1.5, Llama-2 chat, Mistral Instruct and Phi-2.

Text tokenization is an injected dependency (`TextTokenizer`):
  - `HFTokenizerAdapter` wraps a HuggingFace tokenizer, the one a checkpoint
    directory ships (`tokenizer_from_checkpoint`; transformers is imported
    only there);
  - `WordStubTokenizer` is the deterministic hash-based stand-in for
    random-weight serving, checkpoints without tokenizer files, and tests: it
    gives the same ids as the JAX package's (sha1 is deterministic) and
    keeps the properties the decode relies on (BOS first, text ids below the
    action range, trailing EMPTY_TOKEN_ID after "Out:").
"""

from __future__ import annotations

import hashlib
import os
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Protocol, Sequence

import numpy as np

from .action_tokenizer import encode_actions_np
from .constants import BOS_TOKEN_ID, EMPTY_TOKEN_ID, EOS_TOKEN_ID, IGNORE_INDEX


class TextTokenizer(Protocol):
    def encode(self, text: str, add_bos: bool = True) -> List[int]: ...


@dataclass
class PurePromptBuilder:
    """Multi-turn prompt accumulator with the reference's exact formatting
    (base_prompter.py:28-73): human turns wrap as "In: {msg}\nOut: ", gpt
    turns as "{msg}</s>" (an empty message as one space), and the leading
    BOS string is stripped because the tokenizer adds BOS. The subclasses
    change the wrappers and the first human turn."""

    model_family: str = "openvla"
    system_prompt: Optional[str] = None
    bos: str = "<s>"
    eos: str = "</s>"
    prompt: str = ""
    turn_count: int = 0

    def wrap_human(self, msg: str) -> str:
        return f"In: {msg}\nOut: "

    def wrap_gpt(self, msg: str) -> str:
        return f"{msg if msg != '' else ' '}{self.eos}"

    def wrap_first(self, msg: str) -> str:
        return self.wrap_human(msg)

    def add_turn(self, role: str, message: str) -> str:
        want = "human" if self.turn_count % 2 == 0 else "gpt"
        if role != want:
            raise ValueError(f"turn {self.turn_count} is a {want!r} turn, not {role!r}")
        message = message.replace("<image>", "").strip()
        if self.turn_count == 0:
            wrapped = self.wrap_first(message)
        elif role == "human":
            wrapped = self.wrap_human(message)
        else:
            wrapped = self.wrap_gpt(message)
        self.prompt += wrapped
        self.turn_count += 1
        return wrapped

    def get_potential_prompt(self, message: str) -> str:
        return (self.prompt + self.wrap_human(message)).removeprefix(self.bos).rstrip()

    def get_prompt(self) -> str:
        return self.prompt.removeprefix(self.bos).rstrip()


@dataclass
class VicunaV15ChatPromptBuilder(PurePromptBuilder):
    """Vicuna-v1.5 chat format (vicuna_v15_prompter.py:26-80): the system
    prompt leads the first human turn; "USER: ... ASSISTANT: " wrapping."""

    SYS_PROMPT = (
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's questions."
    )

    def __post_init__(self):
        if self.system_prompt is None:
            self.system_prompt = self.SYS_PROMPT
        self.system_prompt = self.system_prompt.strip() + " "

    def wrap_human(self, msg: str) -> str:
        return f"USER: {msg} ASSISTANT: "

    def wrap_first(self, msg: str) -> str:
        return self.system_prompt + self.wrap_human(msg)


@dataclass
class LLaMa2ChatPromptBuilder(PurePromptBuilder):
    """Llama-2 chat format (llama2_chat_prompter.py): [INST]/<<SYS>>
    wrapping, the system prompt folded into the first human turn."""

    SYS_PROMPT = (
        "You are a helpful language and vision assistant. "
        "You are able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
    )

    def __post_init__(self):
        if self.system_prompt is None:
            self.system_prompt = self.SYS_PROMPT
        self.system_prompt = f"<<SYS>\n{self.system_prompt.strip()}\n<</SYS>>\n\n"

    def wrap_human(self, msg: str) -> str:
        return f"[INST] {msg} [/INST] "

    def wrap_first(self, msg: str) -> str:
        return self.wrap_human(self.system_prompt + msg)


@dataclass
class MistralInstructPromptBuilder(PurePromptBuilder):
    """Mistral-Instruct format (mistral_instruct_prompter.py): [INST]
    wrapping, no system prompt."""

    def wrap_human(self, msg: str) -> str:
        return f"[INST] {msg} [/INST] "


@dataclass
class PhiPromptBuilder(PurePromptBuilder):
    """Phi-2 Input/Output format (phi_prompter.py): the CodeGen tokenizer
    adds no special tokens, so BOS/EOS are spelled out in the text."""

    bos: str = "<|endoftext|>"
    eos: str = "<|endoftext|>"

    def wrap_human(self, msg: str) -> str:
        return f"Input: {msg}\nOutput: "

    def wrap_gpt(self, msg: str) -> str:
        return f"{msg if msg != '' else ' '}\n{self.eos}"

    def wrap_first(self, msg: str) -> str:
        return f"{self.bos}{self.wrap_human(msg)}"


# llm_backbone_id -> prompt builder class (models/materialize.py contract)
PROMPT_BUILDERS = {
    "llama2-7b-pure": PurePromptBuilder,
    "llama2-13b-pure": PurePromptBuilder,
    "llama2-7b-chat": LLaMa2ChatPromptBuilder,
    "llama2-13b-chat": LLaMa2ChatPromptBuilder,
    "vicuna-v15-7b": VicunaV15ChatPromptBuilder,
    "vicuna-v15-13b": VicunaV15ChatPromptBuilder,
    "mistral-v0.1-7b-pure": PurePromptBuilder,
    "mistral-v0.1-7b-instruct": MistralInstructPromptBuilder,
    "phi-2-3b": PhiPromptBuilder,
}


class HFTokenizerAdapter:
    """Wraps a HuggingFace tokenizer as a TextTokenizer."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return list(self._tok(text, add_special_tokens=add_bos).input_ids)


def tokenizer_from_checkpoint(checkpoint: Optional[str]) -> TextTokenizer:
    """The HF tokenizer a local checkpoint directory ships, else (no
    directory, no tokenizer files, or no transformers) a warning and the
    WordStubTokenizer. Never reaches the network: only local files are read."""
    if checkpoint is not None and os.path.isdir(checkpoint):
        try:
            from transformers import AutoTokenizer

            return HFTokenizerAdapter(
                AutoTokenizer.from_pretrained(checkpoint, local_files_only=True))
        except Exception as e:  # no transformers, or no tokenizer files in the dir
            reason = str(e).splitlines()[0][:200] if str(e) else ""
            print(f"[tokenizer] could not load a tokenizer from {checkpoint}: "
                  f"{type(e).__name__}: {reason}", file=sys.stderr)
    print("[tokenizer] WARNING: using WordStubTokenizer (no Llama tokenizer available)",
          file=sys.stderr)
    return WordStubTokenizer()


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
