"""Port vs JAX: the reader of Flax's ``params.msgpack`` and the models that
load the JAX package's checkpoints through it.

``read_flax_msgpack`` (sskd_tpu_torch/models/convert.py) is held against
``flax.serialization.msgpack_restore`` on every checkpoint in the
repository and on trees written with the forms Flax uses for large arrays,
bf16, numpy scalars and complex numbers; ``StudentModel`` and
``TeacherModel`` load each checkpoint and encode or score as the JAX models
do (f32 on the CPU, summation order only: 1e-5; 1e-4 at e5-small-v2's full
width).
"""

from pathlib import Path

import flax.serialization as fser
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from sskd_tpu.models.student import StudentModel as JStudent
from sskd_tpu.models.teacher import TeacherModel as JTeacher
from sskd_tpu_torch.exceptions import ModelLoadError
from sskd_tpu_torch.models.convert import read_flax_msgpack
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.models.teacher import TeacherModel

ROOT = Path(__file__).resolve().parent.parent
STUDENTS = ["artifacts/demo/vanilla", "artifacts/demo/run_kd/best_model",
            "artifacts/nb_student/best_model"]
TEACHERS = ["artifacts/demo/teacher", "artifacts/nb_teacher"]
TEXTS = ["what is thunder meadow", "notes on sonnet otter: key points about sonnet otter.",
         "Magenta OTTER reference, everything known!", "x"]


def _same_tree(got, want, path="") -> None:
    """Equal structure and leaves; bf16 leaves bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(want, "dtype"):
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == w.shape, path
            assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  w.view(np.uint16)), path
        else:
            g = np.asarray(got)
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert np.array_equal(g, w, equal_nan=True), path
            assert type(got) is type(want) or isinstance(got, np.ndarray), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("ckpt", STUDENTS + TEACHERS)
def test_reader_equals_msgpack_restore_on_the_repository_checkpoints(ckpt):
    raw = (ROOT / ckpt / "params.msgpack").read_bytes()
    _same_tree(read_flax_msgpack(ROOT / ckpt / "params.msgpack"), fser.msgpack_restore(raw))


def test_reader_reads_the_chunked_form(tmp_path, monkeypatch):
    """Flax writes an array over MAX_CHUNK_SIZE bytes as a dict of flat
    chunks (bge-reranker-large's word embeddings sit just under 2^30); a
    small limit makes it write that form for arrays of a few hundred bytes,
    in f32, int8 and bf16, of several ranks."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 96)
    rng = np.random.default_rng(0)
    tree = {"params": {
        "emb": {"embedding": rng.standard_normal((37, 5)).astype(np.float32)},
        "ints": rng.integers(-128, 127, (3, 7, 11)).astype(np.int8),
        "half": jnp.asarray(rng.standard_normal((9, 13)), dtype=jnp.bfloat16),
        "small": np.arange(4, dtype=np.float32),
    }}
    raw = fser.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in raw
    path = tmp_path / "params.msgpack"
    path.write_bytes(raw)
    got = read_flax_msgpack(path)
    _same_tree(got, fser.msgpack_restore(raw))
    assert got["params"]["emb"]["embedding"].shape == (37, 5)


def test_reader_reads_bf16_scalar_complex_and_every_msgpack_width(tmp_path):
    """bf16 arrays (as torch.bfloat16 views of their bits), numpy scalars
    (ext 3), complex numbers (ext 2), and the msgpack forms of every integer
    width, floats, strings, bins, arrays and maps past their fixed sizes."""
    rng = np.random.default_rng(1)
    tree = {
        "bf16": jnp.asarray(rng.standard_normal((3, 4)), dtype=jnp.bfloat16),
        "bf16_scalar": jnp.bfloat16(1.5),
        "f64": rng.standard_normal(6),
        "u16": np.arange(5, dtype=np.uint16), "b": np.array([True, False]),
        "c64": (rng.standard_normal(3) + 1j).astype(np.complex64),
        "scalars": {"f32": np.float32(2.25), "i64": np.int64(-7), "u8": np.uint8(200)},
        "complex": 3.0 - 0.5j,
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
        "floats": [0.1, -2.5e300, float("inf")],
        "strings": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "bins": [b"", b"x" * 300, b"y" * 70000],
        "flags": [True, False, None],
        "wide_map": {f"k{i}": i for i in range(20)},
        "wide_list": list(range(20)),
        "empty": {},
    }
    raw = fser.msgpack_serialize(tree)  # lists kept as msgpack arrays
    path = tmp_path / "params.msgpack"
    path.write_bytes(raw)
    _same_tree(read_flax_msgpack(path), fser.msgpack_restore(raw))
    # a map of more than 65,535 entries and an array of as many (map 32, array 32)
    big = {"m": {str(i): i for i in range(70000)}, "a": list(range(70000))}
    raw = msgpack.packb(big)
    path.write_bytes(raw)
    assert read_flax_msgpack(path) == msgpack.unpackb(raw, raw=False, strict_map_key=False)


def test_reader_raises_on_truncated_and_unknown_data(tmp_path):
    raw = (ROOT / STUDENTS[0] / "params.msgpack").read_bytes()
    path = tmp_path / "params.msgpack"
    for cut in (0, 1, 7, 100, len(raw) // 2, len(raw) - 1):
        path.write_bytes(raw[:cut])
        with pytest.raises(ModelLoadError):
            read_flax_msgpack(path)
    path.write_bytes(raw + b"\x00")
    with pytest.raises(ModelLoadError, match="after the tree"):
        read_flax_msgpack(path)
    odd = msgpack.ExtType(1, msgpack.packb(((2,), "float8_e4m3fn", b"\0\0"),
                                           use_bin_type=True))
    path.write_bytes(msgpack.packb({"w": odd}))
    with pytest.raises(ModelLoadError, match="dtype"):
        read_flax_msgpack(path)
    path.write_bytes(msgpack.packb({"w": msgpack.ExtType(7, b"abc")}))
    with pytest.raises(ModelLoadError, match="ext code 7"):
        read_flax_msgpack(path)
    short = msgpack.ExtType(1, msgpack.packb(((3,), "float32", b"\0" * 8), use_bin_type=True))
    path.write_bytes(msgpack.packb({"w": short}))
    with pytest.raises(ModelLoadError, match="ndarray"):
        read_flax_msgpack(path)
    path.write_bytes(b"\xc1")
    with pytest.raises(ModelLoadError, match="0xc1"):
        read_flax_msgpack(path)


@pytest.mark.parametrize("ckpt", STUDENTS)
def test_student_loads_the_jax_checkpoint_and_encodes_as_jax(ckpt):
    jm = JStudent(str(ROOT / ckpt), device="cpu")
    tm = StudentModel(str(ROOT / ckpt), device="cpu")
    assert tm.config.hidden_size == jm.config.hidden_size
    assert tm.config.num_layers == jm.config.num_layers
    assert tm.tokenizer.vocab == jm.tokenizer.vocab
    assert (tm.query_prefix, tm.passage_prefix) == (jm.query_prefix, jm.passage_prefix)
    np.testing.assert_allclose(tm.encode_queries(TEXTS), jm.encode_queries(TEXTS),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.encode_documents(TEXTS), jm.encode_documents(TEXTS),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ckpt", TEACHERS)
def test_teacher_loads_the_jax_checkpoint_and_scores_as_jax(ckpt):
    jt = JTeacher(str(ROOT / ckpt), device="cpu")
    tt = TeacherModel(str(ROOT / ckpt), device="cpu")
    pairs = [(a, b) for a in TEXTS[:2] for b in TEXTS]
    np.testing.assert_allclose(tt.score(pairs), jt.score(pairs), rtol=1e-5, atol=1e-5)


def test_weights_pt_wins_over_params_msgpack(tmp_path):
    """A directory holding both files loads the port's weights.pt."""
    jm = JStudent(str(ROOT / STUDENTS[0]), device="cpu")
    saved = jm.save(tmp_path / "both")
    other = StudentModel(str(ROOT / STUDENTS[1]), device="cpu")
    torch.save(other.module.state_dict(), saved / "weights.pt")
    back = StudentModel(str(saved), device="cpu")
    np.testing.assert_array_equal(back.encode_queries(TEXTS), other.encode_queries(TEXTS))


def test_full_width_student_saved_by_jax_loads_and_encodes_as_jax(tmp_path):
    """e5-small-v2 at full width (12 layers, hidden 384, 12 heads, vocab
    30,522), JAX's random init saved by the JAX package's ``save``: the port
    reads its 33M parameters and encodes 4 texts within 1e-4."""
    jm = JStudent("intfloat/e5-small-v2", device="cpu", seed=3)
    saved = jm.save(tmp_path / "e5")
    tm = StudentModel(str(saved), device="cpu")
    assert (tm.config.num_layers, tm.config.hidden_size, tm.config.num_heads,
            tm.config.vocab_size) == (12, 384, 12, 30522)
    np.testing.assert_allclose(tm.encode_documents(TEXTS), jm.encode_documents(TEXTS),
                               rtol=1e-4, atol=1e-4)
