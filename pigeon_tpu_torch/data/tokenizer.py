"""CLIP byte-level BPE tokenizer and its hash fallback.

The port's own copy of `pigeon_tpu/data/tokenizer.py` (`ClipTokenizer`,
`HashTokenizer`, `load_tokenizer`), with the same ids for the same
assets and texts:

  * `ClipTokenizer.from_files(vocab.json, merges.txt)` (or `from_dir`)
    reads the OpenAI CLIP assets and gives HF `CLIPTokenizer`'s ids. Its
    word pattern needs unicode property classes, which the ``regex``
    module has; where that module is missing, `FALLBACK_PATTERN` (the
    ``re`` module's approximation, the JAX package's fallback too) splits
    words instead;
  * `HashTokenizer` — md5 word hashes, BOS = V - 2, EOS = V - 1; runs
    without the assets and is NOT CLIP-compatible.

Both give fixed-length ``(B, context_len)`` int32 arrays with BOS, EOS and
EOS padding (CLIP's convention: the pad token is EOS).
"""

from __future__ import annotations

import gzip
import html
import json
import os
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np


@lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP byte <-> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


#: The word pattern without the ``regex`` module: letters as ``re``'s
#: ``[^\W\d_]``, digits as ASCII ``[0-9]``.
FALLBACK_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|[0-9]|[^\s\w]+",
    re.IGNORECASE | re.UNICODE)

try:
    # CLIP's word pattern needs unicode property classes (\p{L}/\p{N}),
    # which HF CLIPTokenizer takes from the `regex` module: without them
    # non-ASCII place names ("Zürich", "São Paulo") split otherwise.
    import regex as _regex

    _PAT = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE)
except ImportError:
    _PAT = FALLBACK_PATTERN


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """Byte-level BPE matching OpenAI CLIP / HF CLIPTokenizer."""

    def __init__(self, encoder: Dict[str, int],
                 merges: List[Tuple[str, str]], context_len: int = 77):
        self.encoder = encoder
        self.decoder = {v: k for k, v in encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.context_len = context_len
        self.bos_id = encoder["<|startoftext|>"]
        self.eos_id = encoder["<|endoftext|>"]
        self._cache: Dict[str, str] = {}

    # -- construction -----------------------------------------------------

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str,
                   context_len: int = 77) -> "ClipTokenizer":
        """Load HF-format `vocab.json` + `merges.txt`."""
        with open(vocab_path) as f:
            encoder = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines
                  if line and not line.startswith("#version") and
                  len(line.split()) == 2]
        return cls(encoder, merges, context_len)

    @classmethod
    def from_dir(cls, path: str, context_len: int = 77) -> "ClipTokenizer":
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"),
                              context_len)

    # -- BPE --------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first \
                        and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def encode_text(self, text: str) -> List[int]:
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """Texts -> ``(B, context_len)`` int32, BOS + ids + EOS, EOS-padded,
        truncated (keeping final EOS) like HF with truncation=True."""
        out = np.full((len(texts), self.context_len), self.eos_id, np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos_id] + self.encode_text(text) + [self.eos_id]
            if len(ids) > self.context_len:
                ids = ids[:self.context_len - 1] + [self.eos_id]
            out[i, :len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic word-hash tokenizer (fallback when CLIP vocab assets
    are unavailable). Same output contract as `ClipTokenizer`."""

    def __init__(self, vocab_size: int = 49408, context_len: int = 77):
        self.vocab_size = vocab_size
        self.context_len = context_len
        self.bos_id = vocab_size - 2
        self.eos_id = vocab_size - 1

    def encode_text(self, text: str) -> List[int]:
        import hashlib

        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())
        ids = []
        for w in words:
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.context_len), self.eos_id, np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos_id] + self.encode_text(text) + [self.eos_id]
            if len(ids) > self.context_len:
                ids = ids[:self.context_len - 1] + [self.eos_id]
            out[i, :len(ids)] = ids
        return out


def load_tokenizer(vocab_dir: str = "data/clip_vocab",
                   context_len: int = 77,
                   fallback_vocab_size: int = 49408):
    """`ClipTokenizer` where ``vocab_dir`` holds ``vocab.json`` and
    ``merges.txt``, else a `HashTokenizer` of ``fallback_vocab_size`` ids
    (so its ids fit the configured text vocabulary by construction).
    ``scripts/get_clip_vocab.sh`` fetches the assets."""
    vocab = os.path.join(vocab_dir, "vocab.json")
    merges = os.path.join(vocab_dir, "merges.txt")
    if os.path.exists(vocab) and os.path.exists(merges):
        return ClipTokenizer.from_files(vocab, merges, context_len)
    return HashTokenizer(vocab_size=fallback_vocab_size,
                         context_len=context_len)
