"""CLIP byte-pair-encoding tokenizer (host-side; the port's own copy of
``mars_tpu/text/tokenizer.py``).

Implements OpenAI CLIP's BPE scheme over the public
``bpe_simple_vocab_16e6.txt.gz`` merge table (data file only; the
implementation here is written from the published algorithm).  Equivalent to
the reference's tokenizers (reference: clip/simple_tokenizer.py,
clip/clip.py:195-245 ``tokenize``; alpha_clip ships the identical pair).

Vocabulary layout: 256 byte-units, 256 byte-units+'</w>', 48894 merges,
then '<|startoftext|>' and '<|endoftext|>' → 49408 entries.

The reference splits text with the ``regex`` package; the port splits it by
hand (``pretokenize``) with ``regex``'s classes of every code point, read
from ``clip_char_classes.py`` (``tools/make_clip_char_classes.py``), so it
needs no ``regex`` and gives its ``findall`` on any text.
"""
from __future__ import annotations

import bisect
import gzip
import html
import os
from functools import lru_cache
from typing import List

import numpy as np

from mars_tpu_torch.text import clip_char_classes as _classes

# the merge table is data shared with the JAX package, read by path
VOCAB_PATH = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir, "mars_tpu",
                          "text", "assets", "bpe_simple_vocab_16e6.txt.gz")
CONTEXT_LENGTH = 77


@lru_cache()
def bytes_to_unicode():
    """Reversible byte ↔ printable-unicode map (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class ClipTokenizer:
    def __init__(self, bpe_path: str = VOCAB_PATH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
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
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text))
        text = " ".join(_split_spaces(text)).strip().lower()
        ids: List[int] = []
        for token in pretokenize(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids


def _class(ch: str) -> str:
    """``regex``'s class of a character in CLIP's pattern: L, N, S, O or X."""
    return _classes.CLASSES[bisect.bisect_right(_classes.STARTS, ord(ch)) - 1]


def _split_spaces(text: str) -> List[str]:
    """``text`` cut at runs of ``regex``'s ``\\s`` (empty ends kept): with
    ``" ".join`` it is ``regex.sub(r"\\s+", " ", text)``."""
    parts, start, i, n = [], 0, 0, len(text)
    while i < n:
        if _class(text[i]) == "S":
            j = i
            while j < n and _class(text[j]) == "S":
                j += 1
            parts.append(text[start:i])
            start = i = j
        else:
            i += 1
    parts.append(text[start:])
    return parts


# the pattern's literal alternatives, in its order
_LITERALS = ("<|startoftext|>", "<|endoftext|>", "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _literal_at(text: str, i: int, lit: str) -> bool:
    """IGNORECASE's match of ``lit`` at ``text[i]``: a letter also matches
    the characters ``regex`` folds to it (``ſ`` for ``s``)."""
    if i + len(lit) > len(text):
        return False
    for a, b in zip(text[i:i + len(lit)], lit):
        if a != b and a not in _classes.FOLDS.get(b, ""):
            return False
    return True


def pretokenize(text: str) -> List[str]:
    """``regex.findall`` of CLIP's pattern (IGNORECASE) on ``text``: at
    each position the first alternative that matches: a special token, a
    contraction, a run of letters, one number, a run of other characters
    that are not ``\\s``; a position none matches is skipped."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        lit = next((lit for lit in _LITERALS if _literal_at(text, i, lit)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        k = _class(text[i])
        if k == "N":
            out.append(text[i])
            i += 1
        elif k in ("L", "O"):
            j = i + 1
            while j < n and _class(text[j]) == k:
                j += 1
            out.append(text[i:j])
            i = j
        else:
            i += 1
    return out


_default = None


def get_tokenizer() -> ClipTokenizer:
    global _default
    if _default is None:
        _default = ClipTokenizer()
    return _default


def tokenize(texts, context_length: int = CONTEXT_LENGTH, truncate: bool = True) -> np.ndarray:
    """List[str] → (N, 77) int32, matching the reference's ``tokenize``
    (clip/clip.py:195-245): <sot> tokens <eot>, zero-padded, truncated with
    the eot kept in the last slot."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    sot = tok.encoder["<|startoftext|>"]
    eot = tok.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [sot] + tok.encode(t) + [eot]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"text too long: {t!r}")
            ids = ids[:context_length]
            ids[-1] = eot
        out[i, : len(ids)] = ids
    return out
