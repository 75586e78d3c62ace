# Copied from swat_tpu/models/tokenizer.py; the port keeps its own copy, permanently (it imports nothing of swat_tpu).
"""CLIP byte-pair-encoding tokenizer (77-token context).

The reference tokenizes via ``open_clip.get_tokenizer`` /``clip.tokenize``
(reference utils/extras.py:157,129; prompts tokenized in utils/features.py:
34-36).  This is a self-contained reimplementation of the same BPE scheme:

* vocab = 256 byte tokens + 256 byte+"</w>" tokens + 48894 learned merges +
  <|startoftext|> + <|endoftext|> = 49408 entries
* merges come from the standard ``bpe_simple_vocab_16e6.txt.gz`` asset; pass
  its path explicitly or via $SWAT_BPE_PATH.

When the asset is unavailable (hermetic test environments) a deterministic
`HashTokenizer` stands in: same context length / special-token layout (EOT is
the highest id so argmax pooling in the text tower still works), stable
hashing of lower-cased words into the mid-vocab range.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import unicodedata
from typing import Iterable, List, Sequence

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@functools.lru_cache()
def _bytes_to_unicode():
    """Reversible byte <-> printable-unicode map (GPT-2 scheme)."""
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


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


try:                      # CLIP's basic_clean runs ftfy.fix_text first
    import ftfy as _ftfy  # (simple_tokenizer.py); not baked into this
except ImportError:       # image — mojibake inputs tokenize unrepaired
    _ftfy = None          # without it (rare for the benchmark metrics)


def _basic_clean(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    else:
        # ftfy.fix_text NFC-normalizes by default (its `normalization="NFC"`
        # config); without it, combining-accent inputs ("café" as e+U+0301)
        # would tokenize differently from the reference pipeline.
        text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return " ".join(text.split())


class SimpleTokenizer:
    """CLIP BPE tokenizer backed by the standard merges file."""

    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or os.environ.get("SWAT_BPE_PATH")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE vocab not found; set SWAT_BPE_PATH to "
                "bpe_simple_vocab_16e6.txt.gz")
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rb") as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = merges[1: 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]

        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        import regex
        self.pat = regex.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            regex.IGNORECASE)
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]
        self.vocab_size = len(self.encoder)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if (word[i] == first and i < len(word) - 1
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
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t]
                              for t in self._bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH):
        return tokenize_batch(self, texts, context_length)


class HashTokenizer:
    """Deterministic stand-in tokenizer for test environments without the
    BPE asset.  NOT linguistically meaningful — shape/special-token
    compatible only."""

    def __init__(self, vocab_size: int = VOCAB_SIZE):
        self.vocab_size = vocab_size
        self.sot_token = vocab_size - 2
        self.eot_token = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        import hashlib

        words = _whitespace_clean(_basic_clean(text)).lower().split()
        ids = []
        for w in words:
            h = int.from_bytes(
                hashlib.md5(w.encode()).digest()[:4], "little")
            ids.append(1 + h % (self.vocab_size - 3))
        return ids

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH):
        return tokenize_batch(self, texts, context_length)


def tokenize_batch(tokenizer, texts, context_length: int = CONTEXT_LENGTH
                   ) -> np.ndarray:
    """[N, context_length] int32, sot + tokens + eot, zero-padded; overlong
    sequences truncate with EOT in the final slot (matches CLIP behavior)."""
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        toks = ([tokenizer.sot_token] + tokenizer.encode(text)
                + [tokenizer.eot_token])
        if len(toks) > context_length:
            toks = toks[:context_length]
            toks[-1] = tokenizer.eot_token
        out[i, : len(toks)] = toks
    return out


class HFTokenizerAdapter:
    """Wrap a HuggingFace CLIPTokenizer(Fast) directory (vocab.json +
    merges.txt) behind the same interface."""

    def __init__(self, path: str):
        from transformers import CLIPTokenizerFast

        self._tok = CLIPTokenizerFast.from_pretrained(path)
        self.sot_token = self._tok.bos_token_id
        self.eot_token = self._tok.eos_token_id
        self.vocab_size = self._tok.vocab_size

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH):
        return tokenize_batch(self, texts, context_length)


def get_tokenizer(bpe_path: str | None = None,
                  vocab_size: int | None = None):
    """Best available tokenizer for the given asset path:
    * file (``bpe_simple_vocab_16e6.txt[.gz]``) -> SimpleTokenizer
    * directory with HF vocab.json/merges.txt   -> HFTokenizerAdapter
    * NO path given anywhere                    -> HashTokenizer (tests)

    An EXPLICIT path (argument or SWAT_BPE_PATH) that cannot be loaded
    raises — silently substituting the hash tokenizer would build prompt
    embeddings and the text-initialized head from meaningless tokens
    while training proceeds to near-random accuracy (open_clip fails
    loudly here too).

    ``vocab_size`` sizes the HashTokenizer fallback to the MODEL's
    vocabulary (real BPE assets ignore it): without it, tiny test models
    (vocab 512) received 49408-range hash ids that the embedding gather
    silently clamped to the last row, collapsing every prompt token to
    one embedding."""
    explicit = bpe_path or os.environ.get("SWAT_BPE_PATH")
    if explicit and os.path.isdir(explicit):
        return HFTokenizerAdapter(explicit)
    if explicit:
        return SimpleTokenizer(explicit)
    return HashTokenizer(vocab_size or VOCAB_SIZE)
