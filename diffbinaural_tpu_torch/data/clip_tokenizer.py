"""CLIP byte-pair-encoding tokenizer (text-tower frontend) — the port's
own copy of ``diffbinaural_tpu/data/clip_tokenizer.py`` (numpy and the
standard library; the third-party ``regex`` module where it is installed).

The reference encoders' ``forward_text`` path feeds token ids produced by
the external ``clip`` package's SimpleTokenizer (a lowercasing byte-level
BPE over the bundled ``bpe_simple_vocab_16e6.txt.gz`` merges).  That vocab
file is not shipped here; this module implements the same algorithm and
loads merges from a user-supplied path (plain text or gzip, one merge per
line, first line skipped as the version header — the published file's
format).

Contract (matching clip.tokenize):
  * text → NFC-ish cleanup, lowercase, whitespace collapse
  * words split by the CLIP regex; each word → UTF-8 bytes → unicode
    surrogate alphabet → BPE merges, with ``</w>`` appended to word ends
  * ids: [sot] + tokens + [eot], zero-padded/truncated to context_length 77
  * vocab layout: 256 byte symbols + 256 byte+``</w>`` symbols + one id per
    merge + <|startoftext|> + <|endoftext|>  (49408 total for the published
    48894-merge file)
"""

from __future__ import annotations

import functools
import gzip
import html
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

CONTEXT_LENGTH = 77

# The published bpe_simple_vocab_16e6.txt.gz holds more merge lines than the
# tokenizer uses; clip's SimpleTokenizer slices to exactly this many so the
# vocab lands at 49408 with sot/eot at 49406/49407.
N_CLIP_MERGES = 49152 - 256 - 2  # 48894
CLIP_VOCAB_SIZE = 512 + N_CLIP_MERGES + 2  # 49408

try:  # exact \p{L}/\p{N} semantics (clip uses the third-party regex module)
    import regex as _regex

    _WORD_RE = _regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _regex.IGNORECASE,
    )
except ImportError:  # stdlib approximation: [^\W\d_] = letters, \d = digits;
    # the catch-all branch must still consume '_' (\w but not \p{L}/\p{N})
    _WORD_RE = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
        re.IGNORECASE | re.UNICODE,
    )


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """Invertible byte → printable-unicode map (GPT-2/CLIP convention):
    printable ASCII/latin bytes map to themselves, the rest to 256+i."""
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


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """Byte-level BPE with CLIP's vocab layout.

    ``merges``: path to the merges file, or an in-memory list of
    ``(first, second)`` pairs (tests use a tiny synthetic list).

    ``clip_layout``: pad the vocab with inert placeholder tokens so it has
    exactly the published CLIP layout (49408 entries, sot/eot at
    49406/49407) even when fewer than 48894 merges are supplied.  File
    loads always use the published layout (and slice extra merge lines the
    way clip's SimpleTokenizer does).
    """

    def __init__(self, merges, clip_layout: bool = False):
        if isinstance(merges, (str, bytes)):
            opener = gzip.open if str(merges).endswith(".gz") else open
            with opener(merges, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # published file: header line + more merges than used; clip
            # slices to exactly N_CLIP_MERGES (vocab 49408, fixed sot/eot)
            pairs = [
                tuple(line.split()) for line in lines[1:] if len(line.split()) == 2
            ][:N_CLIP_MERGES]
            clip_layout = True
        else:
            pairs = [tuple(m) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab: List[str] = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in pairs)
        if clip_layout:
            assert len(pairs) <= N_CLIP_MERGES, len(pairs)
            # inert placeholders: never produced by encode(), only there so
            # byte-token ids and sot/eot match the published vocab exactly
            vocab.extend(
                f"<|unused{i}|>" for i in range(N_CLIP_MERGES - len(pairs))
            )
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(pairs)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @classmethod
    def default(cls) -> "SimpleTokenizer":
        """Merges-free tokenizer in the published CLIP vocab layout.

        Usable out of the box without the (unshippable, license-bound)
        bpe_simple_vocab_16e6.txt.gz: every id it emits is *id-compatible*
        with the published vocab, because CLIP's layout places the 512
        byte-level symbols at ids 0..511 and sot/eot at 49406/49407
        regardless of the merge table.  Words that the published tokenizer
        would compress into merged tokens are emitted as their byte-level
        decomposition instead — a valid (if longer) encoding that pretrained
        text towers also saw during training for rare words.  For exact
        parity with clip.tokenize, construct with the published merges file.
        """
        return cls([], clip_layout=True)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return word[0]
        while True:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for tok in _WORD_RE.findall(text):
            if tok in ("<|startoftext|>", "<|endoftext|>"):
                ids.append(self.encoder[tok])
                continue
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        # byte-decode FIRST, then turn the literal "</w>" markers into
        # spaces (clip's order; the reverse drops the spaces, since ' ' is
        # not a byte-alphabet symbol)
        raw = bytearray(
            self.byte_decoder[c] for c in text if c in self.byte_decoder
        )
        return (
            raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
        )

    def tokenize(
        self,
        texts,
        context_length: int = CONTEXT_LENGTH,
        truncate: bool = False,
    ) -> np.ndarray:
        """texts: str or list[str] → (B, context_length) int32, clip.tokenize
        semantics (sot/eot framing, zero pad, error-or-truncate on overflow)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length "
                        f"{context_length}"
                    )
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[row, : len(ids)] = ids
        return out
