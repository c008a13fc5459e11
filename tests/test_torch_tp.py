"""Tensor parallelism of the teacher (parallel/tp.py) against the JAX
package's ``shard_params_tp`` on its 8 virtual CPU devices: the port's
sharded scores against its unsharded ones and JAX's sharded ones, the
placement summary, the shard shapes, ``shard_tensor_parallel`` on the model,
a bi-encoder, and the head count that a TP degree must divide.

The port's mesh is ``create_mesh(data_parallel=4, index_parallel=2)`` over
eight CPU entries, as ``tests/test_tp.py`` makes the JAX one; the weights are
the JAX teacher's, carried across by ``models/weights.py``.
"""

import numpy as np
import pytest
import torch

import jax

from sskd_tpu.models import BertConfig as JConfig, TeacherModel as JTeacher
from sskd_tpu.models.bert import BiEncoder as JBiEncoder
from sskd_tpu.parallel.mesh import create_mesh as jcreate_mesh
from sskd_tpu.parallel.tp import shard_params_tp as jshard, tp_sharding_summary as jsummary
from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu_torch.exceptions import ConfigError
from sskd_tpu_torch.kd.teacher_train import TeacherTrainer
from sskd_tpu_torch.models.bert import BertConfig, BiEncoder
from sskd_tpu_torch.models.teacher import TeacherModel
from sskd_tpu_torch.models.weights import bi_encoder_from_jax_params
from sskd_tpu_torch.parallel.mesh import create_mesh
from sskd_tpu_torch.parallel.tp import (
    TensorParallelLayer,
    is_tensor_parallel,
    shard_params_tp,
    tp_sharding_summary,
)
from sskd_tpu_torch.tokenization import WordPieceTokenizer

CORPUS = ["machine learning is great", "paris is in france", "query passage"]
PAIRS = [("what is ml", "machine learning is great"), ("q", "paris is in france"),
         ("query one", "machine learning is great")]


@pytest.fixture(scope="module")
def jteacher():
    tok = JTokenizer.build_from_corpus(CORPUS, vocab_size=256)
    return JTeacher("tiny-tp", config=JConfig.tiny(vocab_size=tok.vocab_size), tokenizer=tok)


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() == 8
    return jcreate_mesh(data_parallel=4, index_parallel=2)


@pytest.fixture(scope="module")
def mesh():
    return create_mesh(data_parallel=4, index_parallel=2, devices=[torch.device("cpu")] * 8)


def _teacher(jteacher) -> TeacherModel:
    tok = WordPieceTokenizer(jteacher.tokenizer.vocab)
    return TeacherModel("tiny-tp", device="cpu", tokenizer=tok,
                        config=BertConfig.tiny(vocab_size=tok.vocab_size),
                        params=jax.tree_util.tree_map(np.asarray, jteacher.params))


def test_tp_scores_match_the_unsharded_port_and_jax(jteacher, jmesh, mesh):
    """Sharded scores within 1e-4 of the unsharded port's and of JAX's
    sharded ones (tests/test_tp.py's bound)."""
    teacher = _teacher(jteacher)
    unsharded = teacher.score(PAIRS)
    original = jteacher.params
    try:
        jteacher.params = jshard(original, jmesh, axis="index")
        jteacher.cleanup()
        jax_tp = jteacher.score(PAIRS)
    finally:
        jteacher.params = original
        jteacher.cleanup()
    teacher.module = shard_params_tp(teacher.module, mesh, axis="index")
    tp = teacher.score(PAIRS)
    np.testing.assert_allclose(tp, unsharded, atol=1e-4)
    np.testing.assert_allclose(tp, jax_tp, atol=1e-4)


def test_tp_sharding_summary_equals_jax(jteacher, jmesh, mesh):
    teacher = _teacher(jteacher)
    want = jsummary(jshard(jteacher.params, jmesh, axis="index"))
    assert tp_sharding_summary(shard_params_tp(teacher.module, mesh)) == want
    # unsharded: every parameter replicated, as JAX counts an unsharded tree
    assert tp_sharding_summary(teacher.module) == {
        "replicated": sum(want.values()), "column": 0, "row": 0, "bias_split": 0}


def test_a_column_shard_is_half_the_matrix(jteacher, mesh):
    """Shard j of a column-split layer holds half its output features (half
    the heads), of a row-split one half its input features; the caller's
    module is left whole."""
    teacher = _teacher(jteacher)
    H, inter = teacher.config.hidden_size, teacher.config.intermediate_size
    tp = shard_params_tp(teacher.module, mesh)
    layer = tp.encoder.layers[0]
    assert isinstance(layer, TensorParallelLayer) and len(layer.shards) == 2
    for shard in layer.shards:
        assert shard.attention.num_heads == teacher.config.num_heads // 2
        assert shard.attention.query.weight.shape == (H // 2, H)
        assert shard.attention.output.weight.shape == (H, H // 2)
        assert shard.attention.output.bias is None  # added once, after the sum
        assert shard.intermediate.weight.shape == (inter // 2, H)
        assert shard.ffn_output.weight.shape == (H, inter // 2)
        assert shard.ffn_output.bias is None
    assert not is_tensor_parallel(teacher.module)
    q = teacher.module.encoder.layers[0].attention.query.weight
    assert torch.equal(torch.cat([s.attention.query.weight for s in layer.shards]), q)


def test_shard_tensor_parallel_on_the_model(jteacher, mesh, tmp_path):
    """After ``shard_tensor_parallel`` the model scores as before (within
    1e-4), also at L = 512 (the flash path); it saves the unsharded
    weights, and its trainer refuses it."""
    teacher = _teacher(jteacher)
    baseline = teacher.score(PAIRS)
    batch = teacher.tokenizer.encode_batch([q for q, _ in PAIRS],
                                           text_pairs=[d for _, d in PAIRS],
                                           max_length=512, pad_to=512)
    long_base = teacher.forward_batch(batch)
    state = {k: v.clone() for k, v in teacher.module.state_dict().items()}
    teacher.shard_tensor_parallel(mesh, axis="index")
    assert is_tensor_parallel(teacher.module)
    np.testing.assert_allclose(teacher.score(PAIRS), baseline, atol=1e-4)
    torch.testing.assert_close(teacher.forward_batch(batch), long_base, rtol=0, atol=1e-4)
    again = TeacherModel(str(teacher.save(tmp_path / "t")), device="cpu")
    for name, t in again.module.state_dict().items():
        assert torch.equal(t, state[name]), name
    with pytest.raises(ConfigError, match="tensor-parallel"):
        TeacherTrainer(teacher)


def test_bi_encoder_tp_matches_unsharded_and_jax(jmesh, mesh):
    """The student tower under the same layout: embeddings within 1e-5 of
    the unsharded port's and of the JAX BiEncoder's sharded forward."""
    cfg = JConfig.tiny(vocab_size=128)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 128, (3, 24)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 10:] = 0
    jm = JBiEncoder(cfg)
    params = jm.init(jax.random.PRNGKey(1), ids, mask)
    want = np.asarray(jm.apply(jshard(params, jmesh, axis="index"), ids, mask))
    model = BiEncoder(BertConfig.tiny(vocab_size=128)).eval()
    model.load_state_dict(bi_encoder_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                                     model.config))
    tids, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    with torch.inference_mode():
        unsharded = model(tids, tmask)
        got = shard_params_tp(model, mesh)(tids, tmask)
    torch.testing.assert_close(got, unsharded, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_a_bf16_teacher_under_tp_scores_from_its_cached_casts(jteacher, mesh):
    """A bf16 teacher split over two devices scores within 2e-2 of the
    unsharded bf16 teacher (bf16 rounds each product to 2^-8; measured
    3.5e-3), and each shard's products reuse the bf16 weights its ``Linear``
    cast once."""
    tok = WordPieceTokenizer(jteacher.tokenizer.vocab)
    teacher = TeacherModel("tiny-tp", device="cpu", tokenizer=tok,
                           config=BertConfig.tiny(vocab_size=tok.vocab_size,
                                                  compute_dtype=torch.bfloat16),
                           params=jax.tree_util.tree_map(np.asarray, jteacher.params))
    unsharded = teacher.score(PAIRS)
    teacher.shard_tensor_parallel(mesh)
    np.testing.assert_allclose(teacher.score(PAIRS), unsharded, atol=2e-2)
    lins = [m for m in teacher.module.encoder.layers.modules() if hasattr(m, "_casts")]
    assert len(lins) == 2 * 2 * 6  # layers x shards x (query, key, value, output, FFN's two)
    cached = [lin._casts["weight"][1] for lin in lins]
    assert all(c.dtype == torch.bfloat16 for c in cached)
    teacher.score(PAIRS)
    assert all(lin._casts["weight"][1] is c for lin, c in zip(lins, cached))


@pytest.mark.parametrize("ip", [3, 8])
def test_a_tp_degree_that_does_not_divide_the_heads_raises(jteacher, ip):
    """A shard holds whole heads: BertConfig.tiny's 4 heads split over 3 or 8
    devices raise (JAX would cut the hidden dimension anywhere)."""
    teacher = _teacher(jteacher)
    mesh = create_mesh(data_parallel=1, index_parallel=ip, devices=[torch.device("cpu")] * ip)
    with pytest.raises(ValueError, match="num_heads=4 does not divide"):
        teacher.shard_tensor_parallel(mesh)
    assert not is_tensor_parallel(teacher.module)
