"""Port vs JAX: the native WordPiece core (native/wordpiece.cc) as the port
binds it (sskd_tpu_torch/tokenization/native.py).

The port builds the core itself with g++ into ``build/native/`` (never
loading ``native/libwordpiece.so``), attaches it where the JAX tokenizer
does, and must give the ids and offsets of the JAX package's native path and
of its own pure Python path, on ASCII text (the core) and non-ASCII text
(pure Python); batch encodes and the models' tokenization equal the JAX
package's too. Two processes building the core at once both load a whole
library.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu.tokenization.native import NativeWordPiece as JNative
from sskd_tpu.tokenization.native import native_available as jax_native_available
from sskd_tpu_torch.tokenization import WordPieceTokenizer
from sskd_tpu_torch.tokenization import native

ROOT = Path(__file__).resolve().parent.parent
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "semantic search with knowledge distillation",
    "punctuation, everywhere! right? (yes) [ok] {fine}",
    "numbers 123 456 and mixed a1b2c3",
]
ASCII = CORPUS + ["", "   ", "single", "UPPERCASE Words MiXeD", "trailing space ", " leading",
                  "a.b.c!d", "unknownzzzwordzzz here", "x" * 300, "tabs\tand\nnewlines\r\n",
                  "~`^|\\ symbols @#$%&*+=<>/"]
NON_ASCII = ["héllo wörld", "naïve café, déjà vu!", "☃ snow — dash", "日本語 text"]


@pytest.fixture(scope="module")
def toks():
    """(JAX tokenizer, port tokenizer, port tokenizer kept on pure Python)."""
    jt = JTokenizer.build_from_corpus(CORPUS, vocab_size=512)
    tt = WordPieceTokenizer(jt.vocab)
    pure = WordPieceTokenizer(jt.vocab)
    pure._native, pure._native_tried = None, True
    return jt, tt, pure


def test_the_core_is_built_under_build_and_attached(toks):
    _, tt, _ = toks
    assert native.native_available()
    path = native.library_path()
    assert path.exists() and path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libwordpiece-") and path != ROOT / "native" / "libwordpiece.so"
    assert tt._native_core() is not None


@pytest.mark.parametrize("text", ASCII + NON_ASCII)
def test_ids_and_offsets_match_jax_and_pure_python(toks, text):
    jt, tt, pure = toks
    got = tt.tokenize_with_offsets(text)
    assert got == pure.tokenize_with_offsets(text) == jt.tokenize_with_offsets(text)
    if text.isascii() and jax_native_available():  # the JAX package's binding of the core
        assert JNative(jt.vocab, jt.unk_id, jt.lowercase).tokenize_with_offsets(text) == got
    assert tt.tokenize(text) == got[0]


def test_batches_match_jax(toks):
    """ids_batch (one threaded core call for an all-ASCII batch) against
    text by text; encode_batch of singles and pairs, all-ASCII and mixed,
    against the JAX package's encode_batch."""
    jt, tt, pure = toks
    rng = np.random.default_rng(0)
    words = " ".join(CORPUS).split()
    texts = [" ".join(rng.choice(words, int(rng.integers(0, 90)))) for _ in range(40)]
    for cap in (1, 8, 64, 512):
        got = tt.ids_batch(texts, cap)
        assert [list(x) for x in got] == [pure.tokenize(t)[:cap] for t in texts]
    mixed = texts[:7] + NON_ASCII
    for batch in (texts, mixed, texts[:1]):
        for length in (16, 128):
            want = jt.encode_batch(batch, max_length=length)
            for tok in (tt, pure):
                got = tok.encode_batch(batch, max_length=length)
                assert {k: v.tolist() for k, v in got.items()} == \
                    {k: v.tolist() for k, v in want.items()}
            pairs = batch[::-1]
            want = jt.encode_batch(batch, text_pairs=pairs, max_length=length)
            got = tt.encode_batch(batch, text_pairs=pairs, max_length=length)
            assert {k: v.tolist() for k, v in got.items()} == \
                {k: v.tolist() for k, v in want.items()}


def test_models_frame_the_same_arrays_with_and_without_the_core(toks):
    """StudentModel.tokenize_batch and TeacherModel.tokenize_pairs cut the
    ids to max_seq_length first; the framed arrays equal those of the pure
    Python path, for texts past max_seq_length too."""
    from sskd_tpu_torch.models.bert import BertConfig
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.models.teacher import TeacherModel

    jt, tt, pure = toks
    rng = np.random.default_rng(1)
    words = " ".join(CORPUS).split()
    texts = [" ".join(rng.choice(words, int(rng.integers(1, 120)))) for _ in range(9)]
    cfg = BertConfig.tiny(vocab_size=len(jt.vocab))
    for max_len in (32, 64):
        arrays = []
        for tok in (tt, pure):
            s = StudentModel("tiny", device="cpu", config=cfg, tokenizer=tok,
                             max_seq_length=max_len)
            t = TeacherModel("tiny", device="cpu", config=cfg, tokenizer=tok,
                             max_seq_length=max_len)
            arrays.append((s.tokenize_batch(texts), s.tokenize_batch(texts, pad_to=80),
                           t.tokenize_pairs(list(zip(texts, texts[::-1])))))
        for a, b in zip(*arrays):
            assert {k: v.tolist() for k, v in a.items()} == {k: v.tolist() for k, v in b.items()}


def test_kill_switch_and_word_limit_keep_pure_python(monkeypatch):
    monkeypatch.setenv("SSKD_NATIVE_TOKENIZER", "0")
    t = WordPieceTokenizer.build_from_corpus(CORPUS, vocab_size=256)
    t.tokenize("anything works")
    assert t._native is None
    monkeypatch.setenv("SSKD_NATIVE_TOKENIZER", "1")
    short = WordPieceTokenizer(t.vocab, max_input_chars_per_word=5)
    assert short._native_core() is None  # the core's limit is 100 characters
    assert short.tokenize("abcdef quick")[0] == short.unk_id


def test_two_processes_building_at_once_both_load_a_whole_library(tmp_path):
    """Both start with no library in a fresh build directory and compile at
    the same time; each links to a name of its own and moves it into place,
    so each loads a whole library and tokenizes as pure Python does."""
    code = (
        "import json, sys\n"
        "from pathlib import Path\n"
        "from sskd_tpu_torch.tokenization import native\n"
        "from sskd_tpu_torch.tokenization.wordpiece import WordPieceTokenizer\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "tok = WordPieceTokenizer.build_from_corpus(['alpha beta, gamma'], vocab_size=64)\n"
        "core = tok._native_core()\n"
        "print(json.dumps({'attached': core is not None,\n"
        "                  'path': str(native.library_path()),\n"
        "                  'ids': tok.tokenize('Alpha, beta gamma!')}))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "build")], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    pure = WordPieceTokenizer.build_from_corpus(["alpha beta, gamma"], vocab_size=64)
    pure._native, pure._native_tried = None, True
    for out in outs:
        assert out["attached"] and Path(out["path"]).parent == tmp_path / "build"
        assert out["ids"] == pure.tokenize("Alpha, beta gamma!")
    assert [p.name for p in (tmp_path / "build").iterdir()] == [Path(outs[0]["path"]).name]


def test_batch_threads_follow_the_batch_bytes(monkeypatch):
    """A serving batch (16 short queries) takes one thread: a thread a core
    for it cost 5 ms a batch on the card's host. A corpus batch takes one
    thread per BYTES_PER_THREAD up to the CPUs the process may use;
    SSKD_TOKENIZER_THREADS, when positive, sets the count."""
    monkeypatch.delenv("SSKD_TOKENIZER_THREADS", raising=False)
    cpus = min(len(os.sched_getaffinity(0)), os.cpu_count())
    assert native.batch_threads(16 * 40) == 1
    assert native.batch_threads(0) == 1
    assert native.batch_threads(3 * native.BYTES_PER_THREAD) == min(3, cpus)
    assert native.batch_threads(256 * 3600) == min(256 * 3600 // native.BYTES_PER_THREAD, cpus)
    monkeypatch.setenv("SSKD_TOKENIZER_THREADS", "3")
    assert native.batch_threads(10) == 3
    monkeypatch.setenv("SSKD_TOKENIZER_THREADS", "many")
    assert native.batch_threads(10) == 1
