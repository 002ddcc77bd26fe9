"""The CLIP BPE tokenizer in pure Python (counterpart of
`img2img_turbo_tpu/models/tokenizer.py`; no torch, no transformers).

What the reference gets from `AutoTokenizer.from_pretrained(
"stabilityai/sd-turbo", subfolder="tokenizer")` (src/pix2pix_turbo.py:32)
called with `max_length=77, padding="max_length", truncation=True`
(src/pix2pix_turbo.py:191-192): byte-level CLIP BPE with </w> word-end
markers, lower-casing and whitespace cleaning (no ftfy), bos / eos
<|startoftext|> / <|endoftext|>, padding with "!" (id 0), as SD 2.x and
SD-Turbo do. It reads the HF `vocab.json` + `merges.txt` pair of a local
directory, or a merges file alone (`merges.txt`, `merges.txt.gz` or
OpenAI's `bpe_simple_vocab_16e6.txt.gz`), from which the vocabulary is
derived (`vocab_from_merges`). Tokenizing is a one-time host step: the
pipelines cache each prompt's embedding.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import Dict, List, Sequence, Union

import numpy as np


@functools.lru_cache()
def bytes_to_unicode():
    """GPT-2 / CLIP's reversible byte -> unicode character map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(a, b) for a, b in zip(word, word[1:])}


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _load_merges(merges_path: str) -> List[str]:
    """Merge lines of an HF merges.txt(.gz), or of OpenAI's
    bpe_simple_vocab_16e6.txt.gz cut to CLIP's 48894 merges (openai/CLIP
    simple_tokenizer.py:68)."""
    opener = gzip.open if merges_path.endswith(".gz") else open
    with opener(merges_path, "rt", encoding="utf-8") as f:
        lines = f.read().split("\n")
    if lines and (lines[0].startswith("#") or len(lines[0].split()) != 2):
        lines = lines[1:]
    merges = [m for m in lines if m and len(m.split()) == 2]
    if merges_path.endswith("bpe_simple_vocab_16e6.txt.gz"):
        merges = merges[:49152 - 256 - 2]
    return merges


class CLIPTokenizer:
    """The HF CLIPTokenizer call surface the pipelines and trainers use.
    `vocab` is a vocab.json path or the {token: id} mapping itself."""

    def __init__(self, vocab: Union[str, Dict[str, int]], merges_path: str,
                 model_max_length: int = 77, pad_token: str = "!"):
        # a non-\p pattern when the `regex` package is missing, as in JAX
        try:
            import regex
            self._pat = regex.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)
        except ImportError:
            self._pat = re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
                r"""[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""", re.IGNORECASE)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if isinstance(vocab, str):
            with open(vocab, encoding="utf-8") as f:
                vocab = json.load(f)
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        merges = [tuple(m.split()) for m in _load_merges(merges_path)]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        self.pad_token = pad_token
        self.pad_token_id = self.encoder.get(pad_token, self.eos_token_id)
        self.model_max_length = model_max_length
        # HF registers pad/bos/eos as special tokens: their literal
        # occurrences are split out before BPE ("!!" with pad "!" is two
        # bare pad ids, not "! !</w>")
        self.special_tokens = {
            "<|startoftext|>": self.bos_token_id,
            "<|endoftext|>": self.eos_token_id,
            pad_token: self.pad_token_id,
        }
        self._special_re = re.compile(
            "(" + "|".join(re.escape(t) for t in
                           sorted(self.special_tokens, key=len,
                                  reverse=True)) + ")")

    @classmethod
    def from_dir(cls, path: str, **kw) -> "CLIPTokenizer":
        """From a directory with the HF pair (vocab.json + merges.txt) or
        only a merges file, whose vocabulary is then derived."""
        vocab = os.path.join(path, "vocab.json")
        for cand in ("merges.txt", "merges.txt.gz",
                     "bpe_simple_vocab_16e6.txt.gz"):
            merges = os.path.join(path, cand)
            if os.path.exists(merges):
                break
        if os.path.exists(vocab):
            return cls(vocab, merges, **kw)
        if not os.path.exists(merges):
            raise FileNotFoundError(
                f"no vocab.json or merges file in {path}; place the "
                "sd-turbo tokenizer files (vocab.json + merges.txt, or a "
                "CLIP BPE merges file such as bpe_simple_vocab_16e6.txt.gz) "
                "there")
        return cls(vocab_from_merges(merges), merges, **kw)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
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
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
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
        self.cache[token] = out
        return out

    def _encode_plain(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in self._pat.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def encode_text(self, text: str) -> List[int]:
        """Raw BPE ids (special-token literals split out first), without
        bos / eos."""
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        for piece in self._special_re.split(text):
            if not piece:
                continue
            if piece in self.special_tokens:
                ids.append(self.special_tokens[piece])
            else:
                ids.extend(self._encode_plain(piece))
        return ids

    def __call__(self, text: Union[str, Sequence[str]],
                 max_length: int = None, padding: str = "max_length",
                 truncation: bool = True) -> np.ndarray:
        """(B, max_length) int32 ids with bos / eos / padding, as HF's
        CLIPTokenizer(..., padding="max_length", truncation=True)."""
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        out = np.full((len(text), max_length), self.pad_token_id, np.int32)
        for i, t in enumerate(text):
            ids = self.encode_text(t)
            if truncation:
                ids = ids[: max_length - 2]
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
            out[i, : len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids
                       if i not in (self.bos_token_id,))
        text = bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace")
        return text.replace("</w>", " ").replace("<|endoftext|>", "").strip()


def vocab_from_merges(merges_path: str) -> Dict[str, int]:
    """The CLIP vocab.json mapping, rebuilt from a merges file: the 256
    byte symbols, their 256 end-of-word forms, one token per merge in merge
    order, then the two specials (OpenAI's clip/simple_tokenizer.py builds
    it the same way, and HF's vocab.json for CLIP is this order)."""
    merges = _load_merges(merges_path)
    symbols = list(bytes_to_unicode().values())
    vocab = symbols + [s + "</w>" for s in symbols]
    vocab += ["".join(m.split()) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    return {tok: i for i, tok in enumerate(vocab)}
