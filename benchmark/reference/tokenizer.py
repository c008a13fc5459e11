"""Plain WordPiece: the benchmark's own vocabulary, tokenization and framing.

Neither configuration's published vocabulary is in the repository, so the
program serves its built-in vocabulary: specials, every printable ASCII
character (word-initial and ``##`` continuation), the whole words of a short
seed text, then frequent suffix pieces, 2,048 entries at most. This module
builds that vocabulary again from the same seed text by the same rule, and
tokenizes with BERT's conventions: lowercase, split on whitespace and ASCII
punctuation, greedy longest-match WordPiece. The traffic is made of the
vocabulary's whole words, one token each, so a text's token count is known
when it is drawn.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
SEED_TEXT = (
    "the quick brown fox jumps over a lazy dog and runs to search for "
    "semantic meaning in documents queries passages models training data "
    "index vector embedding score teacher student distillation knowledge "
    "0 1 2 3 4 5 6 7 8 9 what is how why when where who which does can"
)
VOCAB_LIMIT = 2048


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    return 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126


def basic_words(text: str) -> list[str]:
    """Lowercased words and single punctuation marks, in order (ASCII)."""
    out, buf = [], []
    for ch in text:
        if ch.isspace() or _is_punct(ch):
            if buf:
                out.append("".join(buf))
                buf = []
            if not ch.isspace():
                out.append(ch)
            continue
        buf.append(ch.lower())
    if buf:
        out.append("".join(buf))
    return out


def build_vocab() -> dict[str, int]:
    texts = [SEED_TEXT, " ".join(chr(c) for c in range(33, 127))]
    counts: Counter = Counter()
    chars: set = set()
    for text in texts:
        for word in basic_words(text):
            counts[word] += 1
            chars.update(word)
    vocab = {t: i for i, t in enumerate(SPECIALS)}

    def add(tok: str) -> None:
        if tok not in vocab and len(vocab) < VOCAB_LIMIT:
            vocab[tok] = len(vocab)

    for ch in sorted(chars):
        add(ch)
        add("##" + ch)
    for word, _ in counts.most_common():
        add(word)
    suffixes: Counter = Counter()
    for word, cnt in counts.items():
        for n in (2, 3, 4):
            if len(word) > n:
                suffixes["##" + word[-n:]] += cnt
    for piece, cnt in suffixes.most_common():
        if cnt >= 2:
            add(piece)
    return vocab


class Tokenizer:
    def __init__(self):
        self.vocab = build_vocab()
        self.pad, self.unk, self.cls, self.sep = (self.vocab[t] for t in SPECIALS[:4])

    def whole_words(self) -> list[str]:
        """Entries that are whole alphanumeric words: one token each."""
        return [w for w in self.vocab if w.isalnum()]

    def _pieces(self, word: str) -> list[int]:
        if len(word) > 100:
            return [self.unk]
        ids, start = [], 0
        while start < len(word):
            end, found = len(word), None
            while start < end:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.vocab:
                    found = self.vocab[sub]
                    break
                end -= 1
            if found is None:
                return [self.unk]
            ids.append(found)
            start = end
        return ids

    def tokenize(self, text: str) -> list[int]:
        return [i for w in basic_words(text) for i in self._pieces(w)]

    def frame(self, texts: list[str], length: int) -> tuple[np.ndarray, np.ndarray]:
        """``[CLS] tokens [SEP]`` in ``[B, length]`` ids and mask, each text
        cut to ``length - 2`` tokens."""
        ids = np.full((len(texts), length), self.pad, np.int64)
        mask = np.zeros((len(texts), length), np.int64)
        for row, text in enumerate(texts):
            toks = self.tokenize(text)[: length - 2]
            n = len(toks) + 2
            ids[row, :n] = [self.cls, *toks, self.sep]
            mask[row, :n] = 1
        return ids, mask

    def frame_pairs(self, pairs: list[tuple[str, str]], length: int):
        """``[CLS] a [SEP] b [SEP]`` in ``[B, length]`` ids, mask and token
        types (1 after the first ``[SEP]``); a pair longer than ``length - 3``
        tokens loses one token at a time from its longer side, from ``a`` at
        a tie."""
        ids = np.full((len(pairs), length), self.pad, np.int64)
        mask = np.zeros((len(pairs), length), np.int64)
        types = np.zeros((len(pairs), length), np.int64)
        for row, (a_text, b_text) in enumerate(pairs):
            a, b = self.tokenize(a_text), self.tokenize(b_text)
            while len(a) + len(b) > length - 3:
                if len(a) >= len(b):
                    a = a[:-1]
                else:
                    b = b[:-1]
            seq = [self.cls, *a, self.sep, *b, self.sep]
            ids[row, : len(seq)] = seq
            mask[row, : len(seq)] = 1
            types[row, len(a) + 2 : len(seq)] = 1
        return ids, mask, types
