"""Self-contained WordPiece tokenizer (host-side).

Copy of sskd_tpu/tokenization/wordpiece.py. As there, ASCII text goes
through the C++ core (native/wordpiece.cc, bound by
:mod:`sskd_tpu_torch.tokenization.native`) when it builds, and other text
through pure Python, with the same ids and offsets either way;
``ids_batch`` tokenizes an all-ASCII batch in one multithreaded call of the
core. ``encode_batch`` encodes single texts and (query, passage) pairs, the
cross-encoder's input, as sskd_tpu/tokenization/wordpiece.py:281-399 does;
``frame_batch`` and ``frame_pairs`` frame ids already tokenized, which lets
StudentModel and TeacherModel tokenize each text once.

The reference tokenized through HuggingFace's Rust `tokenizers` via
``transformers.AutoTokenizer`` (reference: src/utils/chunk.py:14,
pyproject.toml:12-13). This build keeps tokenization host-side (it is I/O, not
MXU work) but makes it first-party and dependency-free:

- BERT-style basic tokenization (lowercase, punctuation split) with exact
  character offsets — feeds :class:`sskd_tpu.utils.chunk.TextChunker`.
- Greedy longest-match WordPiece over a BERT-format ``vocab.txt`` — loads the
  real e5/bge vocab files when available, or a corpus-trained vocab offline.
- Fixed-length padded batch encoding (``[B, L]`` int32 arrays) so every
  encoder call has static shapes for XLA (SURVEY.md section 7.1).

When HF tokenizer files exist on disk the loader prefers them for exact
vocab parity; the algorithm here matches BERT WordPiece semantics.
"""

from __future__ import annotations

import json
import os
import unicodedata
from collections import Counter
from pathlib import Path
from typing import Sequence

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = [PAD, UNK, CLS, SEP, MASK]


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (
        (33 <= cp <= 47)
        or (58 <= cp <= 64)
        or (91 <= cp <= 96)
        or (123 <= cp <= 126)
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize_with_offsets(
    text: str, lowercase: bool = True
) -> list[tuple[str, int, int]]:
    """Whitespace + punctuation split with exact char offsets.

    Lowercasing is applied per-character (keeping the first lowercase char)
    so offsets into the original string stay exact.
    """
    out: list[tuple[str, int, int]] = []
    word_start = -1
    buf: list[str] = []

    def flush(end: int) -> None:
        nonlocal word_start
        if buf:
            out.append(("".join(buf), word_start, end))
            buf.clear()
            word_start = -1

    for i, ch in enumerate(text):
        if ch.isspace():
            flush(i)
            continue
        if _is_punctuation(ch):
            flush(i)
            c = ch.lower()[0] if lowercase and ch.lower() else ch
            out.append((c, i, i + 1))
            continue
        if not buf:
            word_start = i
        if lowercase:
            low = ch.lower()
            buf.append(low[0] if low else ch)
        else:
            buf.append(ch)
    flush(len(text))
    return out


class WordPieceTokenizer:
    """Greedy longest-match WordPiece with BERT conventions."""

    def __init__(
        self,
        vocab: dict[str, int],
        lowercase: bool = True,
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.max_input_chars_per_word = max_input_chars_per_word
        for tok in SPECIAL_TOKENS:
            if tok not in self.vocab:
                raise ValueError(f"vocab missing special token {tok}")
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]
        self.mask_id = self.vocab[MASK]
        self._native = None
        self._native_tried = False

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    @classmethod
    def from_vocab_file(cls, path: str | Path, lowercase: bool = True):
        """Load a BERT-format vocab.txt (one token per line, id = line no)."""
        vocab: dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, lowercase=lowercase)

    @classmethod
    def from_pretrained_dir(cls, path: str | Path):
        """Load from a directory holding ``vocab.txt`` (+ optional
        ``tokenizer_config.json`` with ``do_lower_case``)."""
        path = Path(path)
        lowercase = True
        cfg = path / "tokenizer_config.json"
        if cfg.exists():
            with open(cfg) as f:
                lowercase = bool(json.load(f).get("do_lower_case", True))
        return cls.from_vocab_file(path / "vocab.txt", lowercase=lowercase)

    @classmethod
    def build_from_corpus(
        cls,
        texts: Sequence[str],
        vocab_size: int = 8192,
        lowercase: bool = True,
        min_freq: int = 1,
    ):
        """Train an offline vocab: specials + single chars (word-initial and
        ``##`` continuations) + most-frequent whole words, then most-frequent
        suffix pieces. Simple but gives full coverage (char fallback) with
        compact ids — used for demo/test corpora where the real e5 vocab
        files are unavailable (zero-egress environment)."""
        word_counts: Counter[str] = Counter()
        char_set: set[str] = set()
        for text in texts:
            for word, _, _ in basic_tokenize_with_offsets(text, lowercase):
                word_counts[word] += 1
                char_set.update(word)

        vocab: dict[str, int] = {t: i for i, t in enumerate(SPECIAL_TOKENS)}

        def add(tok: str) -> None:
            if tok not in vocab and len(vocab) < vocab_size:
                vocab[tok] = len(vocab)

        for ch in sorted(char_set):
            add(ch)
            add("##" + ch)
        for word, cnt in word_counts.most_common():
            if cnt < min_freq or len(vocab) >= vocab_size:
                break
            add(word)
        # Frequent suffix pieces improve compression on OOV morphology.
        suffix_counts: Counter[str] = Counter()
        for word, cnt in word_counts.items():
            for ln in (2, 3, 4):
                if len(word) > ln:
                    suffix_counts["##" + word[-ln:]] += cnt
        for piece, cnt in suffix_counts.most_common():
            if len(vocab) >= vocab_size:
                break
            if cnt >= max(2, min_freq):
                add(piece)
        return cls(vocab, lowercase=lowercase)

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        ordered = sorted(self.vocab.items(), key=lambda kv: kv[1])
        with open(path / "vocab.txt", "w", encoding="utf-8") as f:
            for tok, _ in ordered:
                f.write(tok + "\n")
        with open(path / "tokenizer_config.json", "w") as f:
            json.dump(
                {"do_lower_case": self.lowercase, "tokenizer_class": "WordPiece"},
                f,
            )

    # ------------------------------------------------------------------
    # Tokenization
    # ------------------------------------------------------------------

    def _wordpiece(self, word: str) -> list[str]:
        if len(word) > self.max_input_chars_per_word:
            return [UNK]
        pieces: list[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def _native_core(self):
        """The C++ core, attached on first use (sskd_tpu/tokenization/
        wordpiece.py:225-241); None when it cannot be built, when
        ``SSKD_NATIVE_TOKENIZER=0``, or for a word-length limit other than
        the core's 100 characters."""
        if not self._native_tried:
            self._native_tried = True
            if (os.environ.get("SSKD_NATIVE_TOKENIZER", "1") != "0"
                    and self.max_input_chars_per_word == 100):
                from sskd_tpu_torch.tokenization.native import NativeWordPiece

                try:
                    self._native = NativeWordPiece(self.vocab, self.unk_id, self.lowercase)
                except (RuntimeError, OSError):
                    self._native = None
        return self._native

    def tokenize_with_offsets(
        self, text: str
    ) -> tuple[list[int], list[tuple[int, int]]]:
        """Token ids + per-token (start_char, end_char) offsets.
        WordPiece pieces of one word share proportional sub-offsets. ASCII
        text runs through the C++ core when it is attached."""
        native = self._native_core()
        if native is not None and text.isascii():
            return native.tokenize_with_offsets(text)
        return self._tokenize_python(text)

    def _tokenize_python(self, text: str) -> tuple[list[int], list[tuple[int, int]]]:
        ids: list[int] = []
        offsets: list[tuple[int, int]] = []
        for word, start, end in basic_tokenize_with_offsets(text, self.lowercase):
            pieces = self._wordpiece(word)
            if pieces == [UNK]:
                ids.append(self.unk_id)
                offsets.append((start, end))
                continue
            pos = start
            for piece in pieces:
                plen = len(piece) - 2 if piece.startswith("##") else len(piece)
                ids.append(self.vocab[piece])
                offsets.append((pos, min(pos + plen, end)))
                pos += plen
        return ids, offsets

    def tokenize(self, text: str) -> list[int]:
        return self.tokenize_with_offsets(text)[0]

    def decode_tokens(self, ids: Sequence[int]) -> list[str]:
        """The token of each id, ``[UNK]`` for an id outside the vocab."""
        return [self.inv_vocab.get(int(i), UNK) for i in ids]

    def ids_batch(self, texts: Sequence[str], cap: int) -> list:
        """The ids of each text, cut to ``cap`` tokens: an all-ASCII batch of
        more than one text in one call of the C++ core (its threads run
        without the GIL), other batches text by text."""
        native = self._native_core()
        if native is not None and len(texts) > 1 and all(t.isascii() for t in texts):
            mat, counts = native.tokenize_ids_matrix(list(texts), cap=cap)
            return [mat[i, : counts[i]] for i in range(len(texts))]
        return [self.tokenize(t)[:cap] for t in texts]

    # ------------------------------------------------------------------
    # Model-input encoding (static shapes)
    # ------------------------------------------------------------------

    def frame_batch(
        self, ids: Sequence[Sequence[int]], length: int
    ) -> dict[str, np.ndarray]:
        """Frame pre-tokenized single texts as ``[CLS] tokens [SEP]`` in
        fixed ``[B, length]`` arrays, truncating to ``length - 2`` tokens."""
        batch = len(ids)
        input_ids = np.full((batch, length), self.pad_id, dtype=np.int32)
        attention_mask = np.zeros((batch, length), dtype=np.int32)
        for bi, a in enumerate(ids):
            a = a[: length - 2]
            n = len(a) + 2
            input_ids[bi, 0] = self.cls_id
            input_ids[bi, 1 : n - 1] = a
            input_ids[bi, n - 1] = self.sep_id
            attention_mask[bi, :n] = 1
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": np.zeros((batch, length), dtype=np.int32),
        }

    def frame_pairs(
        self, a_ids: Sequence[Sequence[int]], b_ids: Sequence[Sequence[int]], length: int
    ) -> dict[str, np.ndarray]:
        """Frame pre-tokenized pairs as ``[CLS] a [SEP] b [SEP]`` in fixed
        ``[B, length]`` arrays, token types 0 up to the first ``[SEP]`` and 1
        after it. Pairs longer than ``length - 3`` tokens lose one token at a
        time from the longer side (from ``a`` at a tie), as the JAX package
        truncates."""
        batch = len(a_ids)
        input_ids = np.full((batch, length), self.pad_id, dtype=np.int32)
        attention_mask = np.zeros((batch, length), dtype=np.int32)
        token_type_ids = np.zeros((batch, length), dtype=np.int32)
        budget = length - 3
        for bi, (a, b) in enumerate(zip(a_ids, b_ids)):
            la, lb = len(a), len(b)
            while la + lb > budget:
                if la >= lb:
                    la -= 1
                else:
                    lb -= 1
            n = la + lb + 3
            input_ids[bi, 0] = self.cls_id
            input_ids[bi, 1 : 1 + la] = a[:la]
            input_ids[bi, 1 + la] = self.sep_id
            input_ids[bi, 2 + la : 2 + la + lb] = b[:lb]
            input_ids[bi, n - 1] = self.sep_id
            token_type_ids[bi, 2 + la : n] = 1
            attention_mask[bi, :n] = 1
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "token_type_ids": token_type_ids,
        }

    def encode_batch(
        self,
        texts: Sequence[str],
        text_pairs: Sequence[str] | None = None,
        max_length: int = 512,
        pad_to: int | None = None,
    ) -> dict[str, np.ndarray]:
        """Encode to fixed-shape ``[B, L]`` arrays, ``L = pad_to or
        max_length``: single texts as ``[CLS] tokens [SEP]``, each cut to
        ``L - 2`` tokens; with ``text_pairs`` (the cross-encoder's input) as
        ``[CLS] a [SEP] b [SEP]`` with token types 0 / 1 (:meth:`frame_pairs`).
        The same arrays as the JAX package's ``encode_batch``."""
        if text_pairs is not None and len(text_pairs) != len(texts):
            raise ValueError("texts and text_pairs must have equal length")
        length = pad_to or max_length
        ids = self.ids_batch(texts, length)
        if text_pairs is None:
            return self.frame_batch(ids, length)
        return self.frame_pairs(ids, self.ids_batch(text_pairs, length), length)


_DEFAULT: WordPieceTokenizer | None = None

_DEFAULT_SEED_TEXT = (
    "the quick brown fox jumps over a lazy dog and runs to search for "
    "semantic meaning in documents queries passages models training data "
    "index vector embedding score teacher student distillation knowledge "
    "0 1 2 3 4 5 6 7 8 9 what is how why when where who which does can"
)


def get_default_tokenizer() -> WordPieceTokenizer:
    """Process-wide default tokenizer. Prefers a real vocab under
    ``SEMANTIC_KD_TOKENIZER_DIR``; otherwise a char-complete built-in vocab
    (full coverage via char fallback, so it tokenizes anything)."""
    global _DEFAULT
    if _DEFAULT is None:
        tok_dir = os.environ.get("SEMANTIC_KD_TOKENIZER_DIR")
        if tok_dir and Path(tok_dir, "vocab.txt").exists():
            _DEFAULT = WordPieceTokenizer.from_pretrained_dir(tok_dir)
        else:
            # ASCII-complete base vocab so any input tokenizes.
            chars = [chr(c) for c in range(33, 127)]
            texts = [_DEFAULT_SEED_TEXT, " ".join(chars)]
            _DEFAULT = WordPieceTokenizer.build_from_corpus(texts, vocab_size=2048)
    return _DEFAULT
