"""CLIP BPE tokenizer (the port's copy of ``mdu_tpu/text/tokenizer.py``,
which is pure Python; self-contained, loads vocab/merges from files).

The reference relies on A1111's prompt pipeline for tokenization
(SURVEY.md L0).  This implements the standard CLIP byte-level BPE:
lowercase, whitespace-collapse, regex split, byte->unicode mapping,
greedy pair merging, with '</w>' end-of-word markers.

Checkpoint vocab files (vocab.json + merges.txt, as shipped with every SD
checkpoint in diffusers layout) are supplied at load time; none are
bundled with the package.  ``HashTokenizer`` is the deterministic
fallback for weight-free tests/benches.
"""
from __future__ import annotations

import json
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    if False else
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE)


class CLIPTokenizer:
    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 max_length: int = 77, pad_with_eot: bool = True):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.max_length = max_length
        self.bos = self.encoder.get("<|startoftext|>", 49406)
        self.eot = self.encoder.get("<|endoftext|>", 49407)
        # SD1/CLIP pads with eot; OpenCLIP (SD2/SDXL enc2) pads with 0
        self.pad_token = self.eot if pad_with_eot else 0
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str, **kw) -> "CLIPTokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#") and len(l.split()) == 2]
        return cls(vocab, merges, **kw)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        res = list(word)
        self._cache[token] = res
        return res

    def tokenize(self, text: str) -> List[int]:
        """Raw BPE ids, no special tokens, no truncation."""
        text = re.sub(r"\s+", " ", text.lower()).strip()
        ids: List[int] = []
        for tok in _PAT.findall(text):
            if tok in ("<|startoftext|>",):
                ids.append(self.bos)
                continue
            if tok in ("<|endoftext|>",):
                ids.append(self.eot)
                continue
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            for piece in self._bpe(mapped):
                ids.append(self.encoder.get(piece, self.eot))
        return ids

    def __call__(self, text: str) -> List[int]:
        """bos + ids + eot, padded/truncated to max_length."""
        ids = self.tokenize(text)[: self.max_length - 2]
        full = [self.bos] + ids + [self.eot]
        full += [self.pad_token] * (self.max_length - len(full))
        return full


class HashTokenizer:
    """Deterministic stand-in when no vocab files are available (tests,
    weight-free benches): words hash into the id space."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos = vocab_size - 2
        self.eot = vocab_size - 1
        self.pad_token = self.eot

    def tokenize(self, text: str) -> List[int]:
        import hashlib

        words = re.findall(r"[a-z0-9]+", text.lower())
        return [int(hashlib.md5(w.encode()).hexdigest(), 16) % (self.vocab_size - 2)
                for w in words]

    def __call__(self, text: str) -> List[int]:
        ids = self.tokenize(text)[: self.max_length - 2]
        full = [self.bos] + ids + [self.eot]
        full += [self.pad_token] * (self.max_length - len(full))
        return full
