"""CLIP BPE tokenizer (self-contained, no open_clip dependency), for the
benchmark's reference: a frozen copy of the measured program's tokenizer,
so that the reference tokenizes a request's prompt itself.

The reference tokenizes via ``open_clip.tokenize`` (clip_embedder.py:187).
This is the standard CLIP byte-pair-encoding tokenizer; it needs the
``bpe_simple_vocab_16e6.txt.gz`` merges file, which ships with every CLIP
distribution and is expected at ``data/bpe_simple_vocab_16e6.txt.gz`` (same
asset-download story as the model checkpoints themselves).

When the vocab file is absent (e.g. hermetic CI), ``tokenize`` falls back to
a deterministic hash tokenizer that produces well-formed token arrays
(sot/eot framing, padded to 77) so the full pipeline remains runnable; the
embeddings are then only meaningful with matching-trained weights, which is
fine for perf benchmarks and shape tests.
"""

from __future__ import annotations

import functools
import gzip
import html
import logging
import os
import re
from typing import List, Sequence, Union

import numpy as np

DEFAULT_BPE_PATH = os.path.join("data", "bpe_simple_vocab_16e6.txt.gz")

SOT_TOKEN = 49406
EOT_TOKEN = 49407
VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77


@functools.lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text):
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text):
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """CLIP's BPE tokenizer (equivalent to open_clip.tokenizer.SimpleTokenizer)."""

    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<start_of_text>": "<start_of_text>",
            "<end_of_text>": "<end_of_text>",
        }
        self.pat = re.compile(
            r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if _has_regex_module()
            else r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        word = " ".join(word)
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens


def _has_regex_module() -> bool:
    return False  # stdlib re only; the ASCII pattern covers CLIP's test corpus


class HashTokenizer:
    """Deterministic fallback when the BPE vocab asset is absent: hashes each
    whitespace word into [0, 49405]. Structurally valid, not BPE-compatible."""

    def encode(self, text: str) -> List[int]:
        words = whitespace_clean(basic_clean(text)).lower().split(" ")
        out = []
        for w in words:
            if not w:
                continue
            h = 2166136261
            for ch in w.encode("utf-8"):
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            out.append(h % (SOT_TOKEN - 1))
        return out


_tokenizer_cache = {}


def get_tokenizer(bpe_path: str = DEFAULT_BPE_PATH):
    key = bpe_path
    if key not in _tokenizer_cache:
        if os.path.exists(bpe_path):
            _tokenizer_cache[key] = SimpleTokenizer(bpe_path)
        else:
            logging.getLogger(__name__).warning(
                "CLIP BPE vocab not found at %s — falling back to the hash "
                "tokenizer. Token ids are NOT BPE-compatible: with real "
                "pretrained weights text conditioning will be garbage. "
                "Provide the open_clip bpe_simple_vocab_16e6.txt.gz asset.",
                bpe_path,
            )
            _tokenizer_cache[key] = HashTokenizer()
    return _tokenizer_cache[key]


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    bpe_path: str = DEFAULT_BPE_PATH,
) -> np.ndarray:
    """Texts -> int32 [B, context_length] with sot/eot framing, truncated like
    open_clip.tokenize(truncate=True)."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer(bpe_path)
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [SOT_TOKEN] + tok.encode(text) + [EOT_TOKEN]
        if len(tokens) > context_length:
            tokens = tokens[: context_length - 1] + [EOT_TOKEN]
        result[i, : len(tokens)] = tokens
    return result
