"""Tokenization: prompts → the int32 id arrays the text encoders consume
(counterpart of ``comfyui_parallelanything_tpu/utils/tokenizer.py``).

Nothing here ships tokenizer tables; everything loads from user-supplied files:

- ``CLIPBPETokenizer`` — CLIP's byte-BPE scheme (bytes→unicode alphabet,
  end-of-word ``</w>`` marker, lowercasing, merge ranks) reading the standard
  ``vocab.json`` + ``merges.txt`` pair.
- ``load_tokenizer_json`` — wraps the HF ``tokenizers`` runtime for
  ``tokenizer.json`` files (T5 and modern CLIP exports).

Output convention matches the SD ecosystem: fixed ``max_len`` windows, BOS/EOS
framing for CLIP, right-padding with a configurable pad id (CLIP-L pads with EOS,
OpenCLIP-G with 0), plus a 0/1 mask for T5-style encoders.

CLIP's split pattern uses the Unicode categories ``\\p{L}`` and ``\\p{N}``, which
the stdlib ``re`` module cannot name. Its letter and number classes are built here
from ``unicodedata`` (every code point whose category starts with ``L`` or ``N``)
plus the table of ``utils/unicode_classes.py``: the code points that the ``regex``
package's newer Unicode tables class as letters or numbers, and U+0345, which that
pattern matches in no class. The pattern is case-sensitive but for its
contractions: the text is lowercased first, and ``re.IGNORECASE`` would let
U+0345 match the letter class through its fold to U+03B9.
"""

from __future__ import annotations

import functools
import json
import os
import re
import unicodedata

import numpy as np

from .unicode_classes import LETTERS, NO_CLASS, NUMBERS


@functools.cache
def _bytes_to_unicode() -> dict[int, str]:
    """CLIP/GPT-2's reversible byte→printable-unicode table: printable ASCII and
    latin-1 map to themselves, the rest shift into 256+."""
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
    return dict(zip(bs, map(chr, cs)))


@functools.cache
def _category_ranges() -> dict[str, str]:
    """``{"L": ..., "N": ..., "none": ...}``: the body of a character class (escaped
    ranges) of every code point whose Unicode category starts with that letter,
    with the newer letters and numbers of ``unicode_classes``; ``"none"`` holds
    its ``NO_CLASS`` code points."""
    spans: dict[str, list] = {"L": [], "N": []}
    # Planes 4-16 hold no letters or numbers (unassigned, tags, private use).
    for cp in range(0x40000):
        major = unicodedata.category(chr(cp))[0]
        runs = spans.get(major)
        if runs is None:
            continue
        if runs and runs[-1][1] == cp - 1:
            runs[-1][1] = cp
        else:
            runs.append([cp, cp])
    spans["L"] += LETTERS
    spans["N"] += NUMBERS
    spans["none"] = list(NO_CLASS)
    return {
        name: "".join(
            re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
            for a, b in runs
        )
        for name, runs in spans.items()
    }


def _word_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class CLIPBPETokenizer:
    """CLIP's byte-BPE with ``</w>`` word suffix, built from vocab.json+merges.txt.

    ``__call__`` returns (ids, mask): ids is (B, max_len) int32 with
    BOS ... EOS padding, mask marks BOS..EOS inclusive.
    """

    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        max_len: int = 77,
        bos: str = "<|startoftext|>",
        eos: str = "<|endoftext|>",
        pad_id: int | None = None,
    ):
        self.vocab = vocab
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.max_len = max_len
        self.bos_id = vocab[bos]
        self.eos_id = vocab[eos]
        self.pad_id = self.eos_id if pad_id is None else pad_id
        self.byte_map = _bytes_to_unicode()
        cls = _category_ranges()
        # CLIP's pattern: contractions, letter runs, single digits, other symbols.
        self._pat = re.compile(
            rf"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[{cls['L']}]+|[{cls['N']}]"
            rf"|[^\s{cls['L']}{cls['N']}{cls['none']}]+"
        )
        self._cache: dict[str, list[int]] = {}

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str, **kw) -> "CLIPBPETokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: list[tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    def _bpe(self, token: str) -> list[str]:
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _word_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            pair = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if pair not in self.ranks:
                break
            first, second = pair
            out: list[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
            if len(word) == 1:
                break
            pairs = _word_pairs(word)
        return list(word)

    def encode(self, text: str) -> list[int]:
        """Text → token ids, unframed/unpadded."""
        ids: list[int] = []
        text = " ".join(text.lower().strip().split())
        for tok in self._pat.findall(text):
            cached = self._cache.get(tok)
            if cached is None:
                mapped = "".join(self.byte_map[b] for b in tok.encode("utf-8"))
                try:
                    cached = [self.vocab[piece] for piece in self._bpe(mapped)]
                except KeyError as e:
                    # Dropping pieces would condition the model on another prompt.
                    raise KeyError(
                        f"BPE piece {e.args[0]!r} (from token {tok!r}) missing from "
                        "the vocab — vocab.json/merges.txt pair mismatch?"
                    ) from e
                self._cache[tok] = cached
            ids.extend(cached)
        return ids

    def __call__(self, texts: str | list[str]) -> tuple[np.ndarray, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), self.max_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), self.max_len), np.int32)
        for r, text in enumerate(texts):
            body = self.encode(text)[: self.max_len - 2]
            row = [self.bos_id, *body, self.eos_id]
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1
        return ids, mask


class JsonTokenizer:
    """tokenizer.json (HF fast format) wrapper — covers T5/modern-CLIP exports.
    Pads/truncates to ``max_len``; appends ``eos_id`` when set (T5 convention)."""

    def __init__(self, tok, max_len: int, eos_id: int | None = None, pad_id: int = 0):
        self._tok = tok
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id

    def __call__(self, texts: str | list[str]) -> tuple[np.ndarray, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), self.max_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), self.max_len), np.int32)
        for r, text in enumerate(texts):
            row = self._tok.encode(text).ids
            if self.eos_id is not None:
                # HF T5 tokenizer.json files append </s> through their
                # post-processor already: strip it so EOS appears exactly once.
                while row and row[-1] == self.eos_id:
                    row = row[:-1]
                row = row[: self.max_len - 1] + [self.eos_id]
            else:
                row = row[: self.max_len]
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1
        return ids, mask


def load_tokenizer_json(
    path: str | os.PathLike, max_len: int = 512, eos_id: int | None = None,
    pad_id: int = 0,
) -> JsonTokenizer:
    try:
        from tokenizers import Tokenizer
    except ImportError as e:
        raise ImportError(
            "tokenizer.json loading needs the 'tokenizers' package; "
            "use CLIPBPETokenizer.from_files for vocab.json+merges.txt"
        ) from e
    return JsonTokenizer(Tokenizer.from_file(os.fspath(path)), max_len, eos_id, pad_id)
