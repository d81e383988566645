"""WordPiece tokenization for the BERT input pipeline.

The port's pure-Python copy of ``gradaccum_tpu/data/tokenization.py``
(google-research/bert's ``run_classifier.py`` contract): basic tokenize
(lowercase, accent strip, punctuation split), greedy longest-match WordPiece
with "##" continuations, and ``[CLS] a [SEP] b? [SEP]`` packing padded to
``max_seq_length`` with an input mask and segment ids. ``build_vocab``
derives a WordPiece-style vocab from a corpus; ``load_vocab`` reads a
one-token-per-line vocab.txt. ASCII text encodes through the repo's native
C++ encoder (``native.NativeWordPiece``) when its library is built,
byte-identical to the Python path; non-ASCII text, and every text without
the library, takes the Python path.
"""

from __future__ import annotations

import collections
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = [PAD, UNK, CLS, SEP, MASK]


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lower: bool = True) -> List[str]:
    """Lowercase, strip accents, split whitespace and punctuation."""
    if lower:
        text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(c for c in text if unicodedata.category(c) != "Mn")
    tokens: List[str] = []
    current = []
    for ch in text:
        if ch.isspace():
            if current:
                tokens.append("".join(current))
                current = []
        elif _is_punctuation(ch):
            if current:
                tokens.append("".join(current))
                current = []
            tokens.append(ch)
        else:
            current.append(ch)
    if current:
        tokens.append("".join(current))
    return tokens


def wordpiece_tokenize(
    token: str, vocab: Dict[str, int], max_chars: int = 100
) -> List[str]:
    """Greedy longest-match-first WordPiece with "##" continuations."""
    if len(token) > max_chars:
        return [UNK]
    pieces: List[str] = []
    start = 0
    while start < len(token):
        end = len(token)
        piece = None
        while start < end:
            sub = token[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                piece = sub
                break
            end -= 1
        if piece is None:
            return [UNK]
        pieces.append(piece)
        start = end
    return pieces


class Tokenizer:
    def __init__(self, vocab: Dict[str, int], lower: bool = True):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.lower = lower
        for tok in (PAD, UNK, CLS, SEP):
            if tok not in vocab:
                raise ValueError(f"vocab is missing special token {tok}")
        self._native = None  # the lazy C++ encoder (ASCII fast path)
        self._native_tried = False

    def _native_encoder(self):
        """The native encoder, built at first use; None without the library
        or when the vocab's ids are not its positions."""
        if not self._native_tried:
            self._native_tried = True
            from gradaccum_tpu_torch.data.native import NativeWordPiece

            if sorted(self.vocab.values()) == list(range(len(self.vocab))):
                tokens = [self.inv_vocab[i] for i in range(len(self.vocab))]
                enc = NativeWordPiece(tokens, self.vocab[PAD], self.vocab[UNK],
                                      self.vocab[CLS], self.vocab[SEP], lower=self.lower)
                if enc.available:
                    self._native = enc
        return self._native

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for token in basic_tokenize(text, self.lower):
            out.extend(wordpiece_tokenize(token, self.vocab))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        unk = self.vocab[UNK]
        return [self.vocab.get(t, unk) for t in tokens]

    def encode(
        self,
        text_a: str,
        text_b: Optional[str] = None,
        max_seq_length: int = 128,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """run_classifier.py feature conversion: ``[CLS] a [SEP] b? [SEP]``,
        truncated then zero-padded; returns (input_ids, input_mask,
        segment_ids) int32 arrays of length max_seq_length. ASCII text
        encodes natively when the library is built (the same bytes)."""
        native = self._native_encoder()
        if native is not None:
            out = native.encode(text_a, text_b, max_seq_length)
            if out is not None:
                return out
        return self._encode_python(text_a, text_b, max_seq_length)

    def _encode_python(self, text_a: str, text_b: Optional[str] = None,
                       max_seq_length: int = 128) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        tokens_a = self.tokenize(text_a)
        tokens_b = self.tokenize(text_b) if text_b else None
        if tokens_b:
            # truncate the longer of the pair until it fits (BERT convention)
            while len(tokens_a) + len(tokens_b) > max_seq_length - 3:
                longer = tokens_a if len(tokens_a) >= len(tokens_b) else tokens_b
                longer.pop()
        else:
            tokens_a = tokens_a[: max_seq_length - 2]

        tokens = [CLS] + tokens_a + [SEP]
        segments = [0] * len(tokens)
        if tokens_b:
            tokens += tokens_b + [SEP]
            segments += [1] * (len(tokens_b) + 1)

        ids = self.convert_tokens_to_ids(tokens)
        mask = [1] * len(ids)
        pad = max_seq_length - len(ids)
        ids += [self.vocab[PAD]] * pad
        mask += [0] * pad
        segments += [0] * pad
        return (
            np.asarray(ids, np.int32),
            np.asarray(mask, np.int32),
            np.asarray(segments, np.int32),
        )

    def encode_batch(self, texts, text_pairs=None, max_seq_length: int = 128):
        pairs = text_pairs if text_pairs is not None else [None] * len(texts)
        native = self._native_encoder()
        if native is not None and texts:
            # one native call for the batch; the rows it declines re-encode
            # through the Python path
            out = native.encode_batch(texts, text_pairs, max_seq_length)
            if out is not None:
                ids, mask, seg, needs_python = out
                for i in np.flatnonzero(needs_python):
                    ids[i], mask[i], seg[i] = self._encode_python(texts[i], pairs[i],
                                                                  max_seq_length)
                return {"input_ids": ids, "input_mask": mask, "segment_ids": seg}
        trip = [self.encode(a, b, max_seq_length) for a, b in zip(texts, pairs)]
        ids, mask, seg = zip(*trip)
        return {
            "input_ids": np.stack(ids),
            "input_mask": np.stack(mask),
            "segment_ids": np.stack(seg),
        }


def load_vocab(path: str, lower: bool = True) -> Tokenizer:
    vocab: Dict[str, int] = {}
    with open(path) as f:
        for i, line in enumerate(f):
            vocab[line.rstrip("\n")] = i
    return Tokenizer(vocab, lower)


def build_vocab(
    corpus: Iterable[str], size: int = 8192, lower: bool = True
) -> Tokenizer:
    """Frequency-based WordPiece-style vocab: specials, single characters
    (whole + "##" continuation forms), then the most frequent whole words."""
    word_counts: collections.Counter = collections.Counter()
    chars = set()
    for text in corpus:
        for tok in basic_tokenize(text, lower):
            word_counts[tok] += 1
            chars.update(tok)
    vocab: Dict[str, int] = {}
    for tok in SPECIAL_TOKENS:
        vocab[tok] = len(vocab)
    for ch in sorted(chars):
        for form in (ch, "##" + ch):
            if form not in vocab:
                vocab[form] = len(vocab)
    for word, _ in word_counts.most_common():
        if len(vocab) >= size:
            break
        if word not in vocab:
            vocab[word] = len(vocab)
    return Tokenizer(vocab, lower)
