"""The LLaMA tokenizer of a transformers directory, read from its
``tokenizer.json`` without ``tokenizers`` or ``transformers``.

An interpreter for the parts of ``tokenizer.json`` that Llama tokenizers
use; any other component raises, naming it:

  - added tokens (``special``, ``lstrip``, ``rstrip``, ``normalized``), split
    out of the text before it is normalised, the leftmost longest first; a
    ``normalized`` one is matched, in its normalised spelling, inside each
    normalised piece;
  - the legacy normalizer ``Sequence[Prepend("▁"), Replace(" ", "▁")]``,
    applied to each piece between added tokens on its own, so the piece
    after ``<image>`` starts with its own "▁"; or the pre-tokenizer
    ``Metaspace`` (``prepend_scheme`` first / always / never, ``split``);
  - BPE by merge rank: the adjacent pair of lowest rank merges first, the
    leftmost among equals (not the longest piece in the vocabulary), with
    ``byte_fallback`` (``<0xNN>`` pieces) and ``fuse_unk``;
  - the post-processor ``TemplateProcessing`` (its single-sequence
    template); with ``tokenizer_config.json``, as ``LlamaTokenizerFast``
    does, BOS and EOS by its ``add_bos_token`` (default true) and
    ``add_eos_token`` (default false) instead;
  - the decoders ``Replace``, ``ByteFallback`` (a run of byte pieces that is
    not UTF-8 gives one U+FFFD a byte), ``Fuse`` and ``Strip``, alone or in
    a ``Sequence``; ``skip_special_tokens``
    drops the special added tokens, and ``clean_up_tokenization_spaces``
    applies transformers' clean-up.

``load(path)`` reads a directory: ``tokenizer.json``, ``tokenizer_config.json``
(the special tokens' names, ``added_tokens_decoder``), and where that has no
``added_tokens_decoder``, ``special_tokens_map.json`` and ``added_tokens.json``,
as transformers reads them.  A directory with only SentencePiece's
``tokenizer.model`` is not read.
"""
from __future__ import annotations

import heapq
import json
import os
import re
from typing import Iterable, List, Optional

# Unicode White_Space (Rust's ``char::is_whitespace``), which the lstrip and
# rstrip of an added token consume
_WHITESPACE = frozenset("\t\n\v\f\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
                        "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")
# transformers' ``clean_up_tokenization``
_CLEAN_UP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"), (" n't", "n't"),
             (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"), (" 're", "'re"))
_BYTE_PIECE = re.compile(r"<0x([0-9A-Fa-f]{2})>")
TOKENIZER_FILE = "tokenizer.json"


def _unsupported(kind: str, spec) -> ValueError:
    return ValueError(f"{TOKENIZER_FILE}: {kind} {spec!r} is not supported")


def _replace_pattern(spec: dict) -> str:
    pattern = spec["pattern"]
    if set(pattern) != {"String"}:
        raise _unsupported("Replace pattern", pattern)
    return pattern["String"]


def _token_name(value) -> Optional[str]:
    """A special token as transformers' configs spell it: a string or an
    AddedToken dict."""
    return value.get("content") if isinstance(value, dict) else value


class LlamaTokenizer:
    """``spec``: ``tokenizer.json`` parsed; ``config``: ``tokenizer_config.json``
    parsed (None: ``tokenizer.json`` alone, as ``tokenizers.Tokenizer`` reads
    it); ``extra_added``: added-token dicts from the other files, each
    added when ``tokenizer.json`` lacks its content."""

    def __init__(self, spec: dict, config: Optional[dict] = None,
                 extra_added: Iterable[dict] = ()):
        model = spec["model"]
        if model.get("type") != "BPE":
            raise _unsupported("model", model.get("type"))
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix",
                    "ignore_merges"):
            if model.get(key):
                raise _unsupported(f"BPE {key}", model[key])
        self.vocab = dict(model["vocab"])
        self.unk_token = model.get("unk_token")
        self.byte_fallback = bool(model.get("byte_fallback"))
        self.fuse_unk = bool(model.get("fuse_unk"))
        self.merges = {}  # (left id, right id) → (rank, merged id)
        for rank, merge in enumerate(model["merges"]):
            left, right = merge.split(" ") if isinstance(merge, str) else merge
            self.merges[(self.vocab[left], self.vocab[right])] = (rank, self.vocab[left + right])

        self.added = {t["content"]: t for t in spec.get("added_tokens") or []}
        for t in extra_added:
            self.added.setdefault(t["content"], t)
        for t in self.added.values():
            if t.get("single_word"):
                raise _unsupported("added token with single_word", t["content"])
        self.id_to_token = {i: tok for tok, i in self.vocab.items()}
        self.id_to_token.update({t["id"]: c for c, t in self.added.items()})
        self.special = {c for c, t in self.added.items() if t.get("special")}

        self._normalizers = self._read_normalizer(spec.get("normalizer"))
        self._metaspace = self._read_pre_tokenizer(spec.get("pre_tokenizer"))
        self._decoders = self._read_decoder(spec.get("decoder"))
        raw = [t for t in self.added.values() if not t.get("normalized")]
        normalized = [t for t in self.added.values() if t.get("normalized")]
        self._raw_split = self._splitter({t["content"]: t for t in raw})
        self._normalized_split = self._splitter({self._normalize(t["content"]): t
                                                 for t in normalized})

        if config is None:
            self.prefix, self.suffix = self._read_template(spec.get("post_processor"))
            self.clean_up, self.eos_token_id = False, None
        else:
            bos = self.token_to_id(_token_name(config.get("bos_token", "<s>")))
            self.eos_token_id = self.token_to_id(_token_name(config.get("eos_token", "</s>")))
            self.prefix = [bos] if config.get("add_bos_token", True) else []
            self.suffix = [self.eos_token_id] if config.get("add_eos_token", False) else []
            self.clean_up = bool(config.get("clean_up_tokenization_spaces", False))

    # -- the pipeline's parts, read from the file --------------------------

    def _read_normalizer(self, spec) -> list:
        if spec is None:
            return []
        steps = spec["normalizers"] if spec["type"] == "Sequence" else [spec]
        out = []
        for step in steps:
            if step["type"] == "Prepend":
                out.append(("prepend", step["prepend"]))
            elif step["type"] == "Replace":
                out.append(("replace", _replace_pattern(step), step["content"]))
            else:
                raise _unsupported("normalizer", step["type"])
        return out

    def _read_pre_tokenizer(self, spec):
        if spec is None:
            return None
        if spec["type"] != "Metaspace":
            raise _unsupported("pre_tokenizer", spec["type"])
        scheme = spec.get("prepend_scheme") or (
            "always" if spec.get("add_prefix_space", True) else "never")
        if scheme not in ("first", "always", "never"):
            raise _unsupported("Metaspace prepend_scheme", scheme)
        return spec["replacement"], scheme, spec.get("split", True)

    def _read_decoder(self, spec) -> list:
        if spec is None:
            return []
        steps = spec["decoders"] if spec["type"] == "Sequence" else [spec]
        for step in steps:
            if step["type"] not in ("Replace", "ByteFallback", "Fuse", "Strip"):
                raise _unsupported("decoder", step["type"])
            if step["type"] == "Replace":
                _replace_pattern(step)
        return steps

    def _read_template(self, spec):
        if spec is None:
            return [], []
        if spec["type"] != "TemplateProcessing":
            raise _unsupported("post_processor", spec["type"])
        prefix, suffix, seen = [], [], False
        for item in spec["single"]:
            if "Sequence" in item:
                seen = True
                continue
            ids = spec["special_tokens"][item["SpecialToken"]["id"]]["ids"]
            (suffix if seen else prefix).extend(ids)
        return prefix, suffix

    @staticmethod
    def _splitter(tokens: dict):
        """(pattern matching any of ``tokens`` leftmost-longest, tokens) or None."""
        if not tokens:
            return None
        keys = sorted(tokens, key=len, reverse=True)
        return re.compile("|".join(re.escape(k) for k in keys)), tokens

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token]["id"]
        return self.vocab.get(token)

    # -- encoding -----------------------------------------------------------

    def _normalize(self, text: str) -> str:
        for step in self._normalizers:
            if step[0] == "prepend":
                text = step[1] + text if text else text
            else:
                text = text.replace(step[1], step[2])
        return text

    @staticmethod
    def _split(text: str, splitter):
        """``text`` → [(start, piece, added token or None)], the added
        tokens split out with their lstrip / rstrip whitespace and empty
        pieces dropped (tokenizers' ``AddedVocabulary.find_matches``)."""
        if splitter is None:
            return [(0, text, None)] if text else []
        pattern, tokens = splitter
        out, offset = [], 0
        for m in pattern.finditer(text):
            token = tokens[m.group()]
            start, stop = m.start(), m.end()
            if token.get("lstrip"):
                s = start
                while s > 0 and text[s - 1] in _WHITESPACE:
                    s -= 1
                start = max(s, offset)
            if token.get("rstrip"):
                while stop < len(text) and text[stop] in _WHITESPACE:
                    stop += 1
            if offset < start:
                out.append((offset, text[offset:start], None))
            out.append((start, text[start:stop], token))
            offset = stop
        if offset < len(text):
            out.append((offset, text[offset:], None))
        return out

    def _pre_tokenize(self, text: str, at_start: bool) -> List[str]:
        if self._metaspace is None:
            return [text]
        rep, scheme, split = self._metaspace
        text = text.replace(" ", rep)
        if not text.startswith(rep) and (scheme == "always" or (scheme == "first" and at_start)):
            text = rep + text
        if not split:
            return [text]
        return [w for w in re.split(f"(?={re.escape(rep)})", text) if w]

    def _bpe(self, word: str) -> List[int]:
        """One word → ids (tokenizers' ``BPE.merge_word`` and
        ``Word.merge_all``)."""
        vocab = self.vocab
        syms, unk = [], None  # unk: a pending (fused) unknown run
        unk_id = vocab.get(self.unk_token) if self.unk_token is not None else None
        for ch in word:
            if ch in vocab:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(vocab[ch])
                continue
            if self.byte_fallback:
                pieces = [vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if None not in pieces:
                    syms.extend(pieces)
                    continue
            if unk_id is None:
                continue
            if unk is not None and not self.fuse_unk:
                syms.append(unk)
            unk = unk_id
        if unk is not None:
            syms.append(unk)

        n = len(syms)
        nxt = list(range(1, n)) + [-1]
        prev = list(range(-1, n - 1))
        alive = [True] * n
        merges = self.merges
        heap = []
        for i in range(n - 1):
            m = merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, i, new = heapq.heappop(heap)
            if not alive[i] or nxt[i] == -1:
                continue
            j = nxt[i]
            m = merges.get((syms[i], syms[j]))
            if m is None or m[1] != new:  # a stale entry
                continue
            syms[i], alive[j] = new, False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prev[nxt[j]] = i
            if prev[i] != -1:
                m = merges.get((syms[prev[i]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[i], m[1]))
            if nxt[i] != -1:
                m = merges.get((new, syms[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        return [s for s, a in zip(syms, alive) if a]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = []
        for start, piece, token in self._split(text, self._raw_split):
            if token is not None:
                ids.append(token["id"])
                continue
            normalized = self._normalize(piece)
            for sub_start, sub, sub_token in self._split(normalized, self._normalized_split):
                if sub_token is not None:
                    ids.append(sub_token["id"])
                    continue
                for word in self._pre_tokenize(sub, start == 0 and sub_start == 0):
                    ids.extend(self._bpe(word))
        return self.prefix + ids + self.suffix if add_special_tokens else ids

    # -- decoding -----------------------------------------------------------

    @staticmethod
    def _byte_fallback(tokens: List[str]) -> List[str]:
        out, pending = [], bytearray()

        def flush():
            if pending:
                try:
                    out.append(pending.decode("utf-8"))
                except UnicodeDecodeError:
                    out.extend("\ufffd" * len(pending))
                pending.clear()

        for tok in tokens:
            m = _BYTE_PIECE.fullmatch(tok)
            if m:
                pending.append(int(m.group(1), 16))
            else:
                flush()
                out.append(tok)
        flush()
        return out

    def _decode_step(self, step: dict, tokens: List[str]) -> List[str]:
        kind = step["type"]
        if kind == "Replace":
            old = _replace_pattern(step)
            return [t.replace(old, step["content"]) for t in tokens]
        if kind == "ByteFallback":
            return self._byte_fallback(tokens)
        if kind == "Fuse":
            return ["".join(tokens)]
        # Strip
        content, left, right = step["content"], step["start"], step["stop"]
        out = []
        for t in tokens:
            a = 0
            while a < min(left, len(t)) and t[a] == content:
                a += 1
            b = len(t)
            while len(t) - b < right and b > a and t[b - 1] == content:
                b -= 1
            out.append(t[a:b])
        return out

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        tokens = []
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None or (skip_special_tokens and tok in self.special):
                continue
            tokens.append(tok)
        for step in self._decoders:
            tokens = self._decode_step(step, tokens)
        text = "".join(tokens)
        if self.clean_up:
            for old, new in _CLEAN_UP:
                text = text.replace(old, new)
        return text


def load(path: str) -> LlamaTokenizer:
    """The tokenizer of a transformers directory (the module docstring)."""
    spec_path = os.path.join(path, TOKENIZER_FILE)
    if not os.path.exists(spec_path):
        sp = " (its tokenizer.model, SentencePiece's format, is not read)" if os.path.exists(
            os.path.join(path, "tokenizer.model")) else ""
        raise FileNotFoundError(f"{TOKENIZER_FILE} is not in {path}{sp}")
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    config = _read_json(os.path.join(path, "tokenizer_config.json"))
    extra = []
    if "added_tokens_decoder" in config:
        extra = [{"id": int(i), **t} for i, t in config["added_tokens_decoder"].items()]
    else:
        specials = _read_json(os.path.join(path, "special_tokens_map.json"))
        config.update({k: v for k, v in specials.items() if k in ("bos_token", "eos_token")})
        names = {_token_name(v) for v in specials.values() if not isinstance(v, list)}
        extra = [{"id": i, "content": c, "lstrip": False, "rstrip": False,
                  "normalized": c not in names, "special": c in names}
                 for c, i in _read_json(os.path.join(path, "added_tokens.json")).items()]
    return LlamaTokenizer(spec, config, extra)


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)
