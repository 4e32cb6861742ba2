r"""CLIP byte-pair-encoding tokenizer, pure Python (counterpart of
``mode_diffusion_policy_tpu/models/encoders/tokenizer.py``).

The standard OpenAI CLIP BPE over the public ``bpe_simple_vocab_16e6.txt.gz``
merges table (this package's own copy). Token ids and the ``tokenize()``
batch layout (<|startoftext|> ... <|endoftext|> zero-padded to 77) are the
JAX package's and the reference's.

The JAX tokenizer splits words with the ``regex`` module's ``\p{L}`` and
``\p{N}`` classes; the stdlib ``re`` has no ``\p{...}``, so the classes are
built here once from ``unicodedata.category`` (categories L* and N*), and
``\s`` is the Unicode White_Space property, which ``regex`` uses (``re``'s
``\s`` also takes U+001C-U+001F). Under ``regex``'s IGNORECASE a
character whose case forms are letters, though it is not one, falls in
neither ``[\p{L}]`` nor ``[^\s\p{L}\p{N}]`` (U+0345): it is left out of
the last class here too. The pattern is compiled without IGNORECASE: the
text is lower-cased first. The only remaining differences are code points
that one module's Unicode tables assign and the other's do not
(tests/test_torch_clip_text.py checks every code point up to U+FFFF).

Cleaning is html-unescape + whitespace normalization (the reference's
``ftfy.fix_text`` is not used; identical for well-formed text, which every
CALVIN and LIBERO instruction is).
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
import sys
import unicodedata
from typing import List, Union

import numpy as np


@functools.lru_cache()
def default_bpe() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bpe_simple_vocab_16e6.txt.gz")


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode mapping (standard GPT-2/CLIP
    scheme): printable ASCII/latin ranges map to themselves, the rest shift
    into the 256+ plane."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# the Unicode White_Space property (the ``regex`` module's ``\s``)
_WHITESPACE = ("\t\n\x0b\x0c\r\x20\x85\xa0\u1680\u2000-\u200a\u2028\u2029"
               "\u202f\u205f\u3000")


def _ranges(cps) -> str:
    """A character-class body for sorted code points, as escaped ranges."""
    out, cps = [], list(cps)
    i = 0
    while i < len(cps):
        j = i
        while j + 1 < len(cps) and cps[j + 1] == cps[j] + 1:
            j += 1
        a, b = cps[i], cps[j]
        out.append(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}")
        i = j + 1
    return "".join(out)


@functools.lru_cache()
def unicode_classes():
    r"""(letters, numbers, case-folded letters): character-class bodies for
    ``\p{L}`` and ``\p{N}`` from ``unicodedata``, and the characters that
    are no letter but whose single-character case forms are (which
    ``regex``'s IGNORECASE leaves out of a negated class with ``\p{L}``)."""
    letters, numbers, folded = [], [], []
    for cp in range(sys.maxunicode + 1):
        c = chr(cp)
        cat = unicodedata.category(c)[0]
        if cat == "L":
            letters.append(cp)
        elif cat == "N":
            numbers.append(cp)
        if cat != "L" and any(len(v) == 1 and unicodedata.category(v)[0]
                              == "L" for v in (c.upper(), c.lower(),
                                               c.casefold())):
            folded.append(cp)
    return _ranges(letters), _ranges(numbers), _ranges(folded)


def word_pattern() -> "re.Pattern":
    """The CLIP pre-tokenization pattern over lower-cased text."""
    L, N, F = unicode_classes()
    return re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        f"[{L}]+|[{N}]|[^{_WHITESPACE}{L}{N}{F}]+")


def _pairs(word):
    return set(zip(word[:-1], word[1:]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(f"[{_WHITESPACE}]+", " ", text).strip()


class CLIPTokenizer:
    """BPE tokenizer with the CLIP vocabulary (49408 tokens)."""

    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or default_bpe()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.pat = word_pattern()

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs(word)
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
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _clean(text).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")


_default_tokenizer = None


def get_tokenizer() -> CLIPTokenizer:
    global _default_tokenizer
    if _default_tokenizer is None:
        _default_tokenizer = CLIPTokenizer()
    return _default_tokenizer


def tokenize(texts: Union[str, List[str]], context_length: int = 77,
             truncate: bool = False) -> np.ndarray:
    """Batch-tokenize to a [N, context_length] int32 array."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    sot, eot = tok.sot_token, tok.eot_token
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tok.encode(text) + [eot]
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[:context_length]
                tokens[-1] = eot
            else:
                raise RuntimeError(
                    f"Input {texts[i]} is too long for context length "
                    f"{context_length}")
        result[i, : len(tokens)] = tokens
    return result
