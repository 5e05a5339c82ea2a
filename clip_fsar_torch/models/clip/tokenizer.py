"""CLIP byte-pair-encoding tokenizer (host-side, pure Python; copy of
clip_fsar_tpu/models/clip/tokenizer.py:24-141, with its own copy of the merges file beside it).

Same tokenization behavior as the vendored OpenAI tokenizer in the
reference (models/base/few_shot.py:63-180, tokenize at :393-429) against
the same merges file (bpe_simple_vocab_16e6.txt.gz).  Fresh
implementation of the standard public BPE algorithm.

ftfy is not a dependency; text cleanup is
html-unescape + whitespace normalization, which is lossless for the ASCII
class-name prompts CLIP-FSAR uses.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Dict, List, Tuple, Union

import numpy as np
import regex as re

_VOCAB_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz")

_WORD_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def byte_unicode_table() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (standard GPT-2/CLIP table).

    Printable bytes map to themselves; the rest shift into 256+ codepoints
    so every byte has a visible, non-whitespace character.
    """
    keep = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    mapped = keep[:]
    shift = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            mapped.append(256 + shift)
            shift += 1
    return dict(zip(keep, (chr(c) for c in mapped)))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip().lower()


class SimpleTokenizer:
    def __init__(self, bpe_path: str = _VOCAB_PATH):
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")
        # line 0 is a version header; CLIP uses merges [1, 49152-256-2+1)
        merges: List[Tuple[str, str]] = [tuple(m.split()) for m in merge_lines[1 : 49152 - 256 - 2 + 1]]

        vocab: List[str] = list(self.byte_encoder.values())
        vocab += [c + "</w>" for c in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)

        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)

        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in re.findall(_WORD_PATTERN, _clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts: Union[str, List[str]], context_length: int = 77, truncate: bool = False) -> np.ndarray:
    """Tokenize into a fixed [N, context_length] int32 array with
    <|startoftext|> ... <|endoftext|> framing and zero padding
    (reference few_shot.py:393-429)."""
    if isinstance(texts, str):
        texts = [texts]
    tk = _default_tokenizer()
    sot = tk.encoder["<|startoftext|>"]
    eot = tk.encoder["<|endoftext|>"]
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tk.encode(text) + [eot]
        if len(tokens) > context_length:
            if not truncate:
                raise RuntimeError(f"Input {text!r} is too long for context length {context_length}")
            tokens = tokens[:context_length]
            tokens[-1] = eot
        result[i, : len(tokens)] = tokens
    return result
