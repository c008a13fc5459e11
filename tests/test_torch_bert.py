"""Port vs JAX: the bi-encoder forward, on weights carried across with
bi_encoder_from_jax_params. f32; atol 1e-5 on the L2-normalized embeddings
covers summation order through two layers."""

import numpy as np
import pytest
import torch

import jax

from sskd_tpu.models.bert import BertConfig as JConfig, BiEncoder as JBiEncoder
from sskd_tpu.models.student import StudentModel as JStudent
from sskd_tpu_torch.models.bert import BertConfig, BiEncoder
from sskd_tpu_torch.models.student import ARCH_KEYS, StudentModel
from sskd_tpu_torch.models.weights import bi_encoder_from_jax_params, random_jax_params
from sskd_tpu_torch.tokenization import WordPieceTokenizer

NB_STUDENT = "artifacts/nb_student/best_model"


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(seed, B, L, vocab):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, L // 2 :] = 0
    mask[2, 3:] = 0
    ids[mask == 0] = 0
    return ids, mask


def _port_forward(params, cfg, ids, mask):
    model = BiEncoder(cfg)
    model.load_state_dict(bi_encoder_from_jax_params(params, cfg))
    with torch.inference_mode():
        return model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("L", [16, 128])
def test_tiny_bi_encoder_matches_jax(L):
    jm = JBiEncoder(JConfig.tiny())
    ids, mask = _batch(L, 3, L, 2048)
    params = jm.init(jax.random.PRNGKey(0), ids, mask)
    want = np.asarray(jm.apply(params, ids, mask))
    got = _port_forward(_numpy_tree(params), BertConfig.tiny(), ids, mask)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_random_params_have_the_flax_tree():
    """random_jax_params draws the same tree Flax initializes, so JAX can
    apply it and both packages agree on it."""
    jm = JBiEncoder(JConfig.tiny())
    ids, mask = _batch(1, 3, 16, 2048)
    ref = jm.init(jax.random.PRNGKey(0), ids, mask)
    drawn = random_jax_params(BertConfig.tiny(), seed=3)
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    assert shapes(drawn) == shapes(_numpy_tree(ref))
    want = np.asarray(jm.apply(drawn, ids, mask))
    np.testing.assert_allclose(_port_forward(drawn, BertConfig.tiny(), ids, mask), want, atol=1e-5)


@pytest.fixture(scope="module")
def nb_pair(tmp_path_factory):
    js = JStudent(NB_STUDENT)
    ts = StudentModel(
        device="cpu",
        config=BertConfig(**{k: getattr(js.config, k) for k in ARCH_KEYS}),
        tokenizer=WordPieceTokenizer.from_pretrained_dir(f"{NB_STUDENT}/tokenizer"),
        params=_numpy_tree(js.params),
    )
    return js, ts


def test_nb_student_tokenizer_ids_match(nb_pair):
    js, ts = nb_pair
    texts = ["query: what is the capital of france?", "passage: Paris, the city of light.",
             "unknown-wörds & punctuation!!", ""]
    for t in texts:
        assert ts.tokenizer.tokenize(t) == js.tokenizer.tokenize(t)
    jb, tb = js.tokenize_batch(texts), ts.tokenize_batch(texts)
    np.testing.assert_array_equal(tb["input_ids"], jb["input_ids"])
    np.testing.assert_array_equal(tb["attention_mask"], jb["attention_mask"])


@pytest.mark.parametrize("kind", ["queries", "documents"])
def test_nb_student_embeddings_match(nb_pair, kind):
    js, ts = nb_pair
    texts = [f"sample text number {i} about search and distillation" for i in range(5)]
    want = getattr(js, f"encode_{kind}")(texts)
    got = getattr(ts, f"encode_{kind}")(texts)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_port_checkpoint_round_trip(nb_pair, tmp_path):
    _, ts = nb_pair
    ts.save(tmp_path / "ckpt")
    again = StudentModel(str(tmp_path / "ckpt"), device="cpu")
    texts = ["round trip"]
    np.testing.assert_array_equal(again.encode(texts), ts.encode(texts))


def test_tiny_student_bf16_at_512_matches_jax():
    """The --tiny student in bf16 at L = 512, where the port's attention
    takes flash (on the CPU its plain version; on the card the tensor-core
    kernel at head dim 16), against the JAX StudentModel in bf16 on the same
    parameters, carried over by bi_encoder_from_jax_params: 2 passages of
    more than 512 tokens, cut to 512. Each embedding's cosine with JAX's is
    at least 0.999 (bf16 rounding of two layers' products, each side its
    own order)."""
    import jax.numpy as jnp

    from sskd_tpu.tokenization.wordpiece import WordPieceTokenizer as JTokenizer

    rng = np.random.default_rng(11)
    words = ("semantic search distillation teacher student passage query index "
             "vector embedding score model training retrieval ranking").split()
    texts = [" ".join(rng.choice(words, 600)) for _ in range(2)]
    corpus = [" ".join(words), " ".join(chr(c) for c in range(33, 127))]
    params = random_jax_params(BertConfig.tiny(), seed=5)
    js = JStudent(config=JConfig.tiny(compute_dtype=jnp.bfloat16), params=params,
                  tokenizer=JTokenizer.build_from_corpus(corpus, vocab_size=2048))
    ts = StudentModel(device="cpu", config=BertConfig.tiny(compute_dtype=torch.bfloat16),
                      params=params,
                      tokenizer=WordPieceTokenizer.build_from_corpus(corpus, vocab_size=2048))
    assert ts.tokenize_batch(texts)["input_ids"].shape == (2, 512)
    want, got = js.encode_documents(texts), ts.encode_documents(texts)
    cos = (got * want).sum(axis=1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
    assert cos.min() >= 0.999, cos
