"""Port vs JAX: the public functions ported last, each on the same seeded
inputs, and the port's /metrics against infra/alert_rules.yml.

Tolerances: the quantization diagnostics, the similarity matrix, the
converted parameter tree, the decoded tokens and the native ids are equal
(the port quantizes with XLA's arithmetic step for step, so the dequantized
rows are the same bits); encodes and scores around ``cleanup`` equal
themselves bit for bit and the JAX package's within 1e-5; ``new_rng`` keeps
the JAX function's contract (n fresh, distinct streams, the same for the
same seed), not its threefry bits."""

import json
import logging
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sskd_tpu.models import convert as jconvert
from sskd_tpu.models.bert import BertConfig as JConfig
from sskd_tpu.models.student import StudentModel as JStudent
from sskd_tpu.models.teacher import TeacherModel as JTeacher
from sskd_tpu.ops import quant as jquant
from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu.tokenization.native import NativeWordPiece as JNative
from sskd_tpu.tokenization.native import native_available as jax_native_available
from sskd_tpu.utils import logging as jlog
from sskd_tpu.utils import seed as jseed
from sskd_tpu_torch.models import convert
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.models.teacher import TeacherModel
from sskd_tpu_torch.ops import quant
from sskd_tpu_torch.serve.metrics import Metrics
from sskd_tpu_torch.tokenization import WordPieceTokenizer
from sskd_tpu_torch.tokenization.native import NativeWordPiece
from sskd_tpu_torch.utils import logging as tlog
from sskd_tpu_torch.utils import seed as tseed

ROOT = Path(__file__).resolve().parent.parent
CORPUS = [f"document about topic {i} with words {i * 7 % 13}" for i in range(40)]
TEXTS = ["find topic 3", "words 5 topic", "what about topic 17"]


@pytest.fixture(scope="module")
def jtok():
    return JTokenizer.build_from_corpus(CORPUS + ["query passage what find about"],
                                        vocab_size=256)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantization_error_matches_jax(bits, monkeypatch):
    rng = np.random.default_rng(31)
    x = rng.standard_normal((50, 64)).astype(np.float32)
    x[3] = 0.0  # an all-zero row: the 1e-9 floors
    fn, jfn = ((quant.quantization_error, jquant.quantization_error) if bits == 8 else
               (quant.quantization_error_int4, jquant.quantization_error_int4))
    got, want = fn(x, device="cpu"), jfn(x)
    assert got == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fn(x)  # the device defaults to CUDA


def test_compute_similarity_and_cleanup_match_jax(jtok):
    """The [nq, nd] matrix; after ``cleanup`` (the bf16 casts dropped, the
    JAX package's compiled encodes) the same embeddings as before."""
    js = JStudent("tiny-api", config=JConfig.tiny(vocab_size=jtok.vocab_size), tokenizer=jtok)
    ts = StudentModel("tiny-api", device="cpu", tokenizer=WordPieceTokenizer(jtok.vocab),
                      config=BertConfig.tiny(vocab_size=jtok.vocab_size),
                      params=jax.tree_util.tree_map(np.asarray, js.params),
                      compute_dtype=torch.bfloat16)
    q, d = js.encode_queries(TEXTS), js.encode_documents(CORPUS[:7])
    np.testing.assert_array_equal(ts.compute_similarity(q, d), js.compute_similarity(q, d))
    assert ts.compute_similarity(q, d).shape == (3, 7)
    before, jbefore = ts.encode(TEXTS), js.encode(TEXTS)
    casts = [m._casts for m in ts.module.modules() if hasattr(m, "_casts")]
    assert any(casts)
    ts.cleanup()
    js.cleanup()
    assert not any(casts) and not js._encode_jit
    np.testing.assert_array_equal(ts.encode(TEXTS), before)
    np.testing.assert_array_equal(js.encode(TEXTS), jbefore)


def test_teacher_cleanup_matches_jax(jtok):
    jt = JTeacher("tiny-api-teacher", config=JConfig.tiny(vocab_size=jtok.vocab_size),
                  tokenizer=jtok)
    tt = TeacherModel("tiny-api-teacher", device="cpu", tokenizer=WordPieceTokenizer(jtok.vocab),
                      config=BertConfig.tiny(vocab_size=jtok.vocab_size),
                      params=jax.tree_util.tree_map(np.asarray, jt.params))
    pairs = [(t, c) for t in TEXTS for c in CORPUS[:2]]
    before, jbefore = tt.score(pairs), jt.score(pairs)
    np.testing.assert_allclose(before, jbefore, rtol=1e-5, atol=1e-5)
    tt.cleanup()
    jt.cleanup()
    assert not jt._score_jit
    assert all(not m._casts for m in tt.module.modules() if hasattr(m, "_casts"))
    assert tt.score(pairs) == before and jt.score(pairs) == jbefore


def test_decode_tokens_matches_jax(jtok):
    tok = WordPieceTokenizer(jtok.vocab)
    ids = list(range(jtok.vocab_size)) + [jtok.vocab_size, 10_000, -1]
    assert tok.decode_tokens(ids) == jtok.decode_tokens(ids)
    assert tok.decode_tokens(np.asarray(tok.tokenize(CORPUS[5]))) == \
        jtok.decode_tokens(jtok.tokenize(CORPUS[5]))
    assert tok.decode_tokens([10_000]) == ["[UNK]"]


def test_tokenize_ids_view_matches_jax(jtok):
    tok = WordPieceTokenizer(jtok.vocab)
    native = NativeWordPiece(tok.vocab, tok.unk_id, tok.lowercase)
    jnative = JNative(jtok.vocab, jtok.unk_id, jtok.lowercase) if jax_native_available() else None
    for text in CORPUS[:5] + ["UNSEEN words, punctuation!", ""]:
        view = native.tokenize_ids_view(text)
        assert view.dtype == np.int32 and view.base is not None  # a view of the scratch buffer
        assert view.tolist() == tok.tokenize(text) == jtok.tokenize(text)
        if jnative is not None:
            np.testing.assert_array_equal(view, jnative.tokenize_ids_view(text))


def test_flush_logs_is_a_barrier_as_in_jax(tmp_path):
    for pkg, name in ((tlog, "port"), (jlog, "jax")):
        log_file = tmp_path / f"{name}.log"
        root = logging.getLogger(pkg._ROOT_NAME)
        saved = (root.handlers[:], root.level, root.propagate, pkg._CONFIGURED)
        try:
            logger = pkg.setup_logging(log_file=log_file, force=True, enqueue=True)
            logger.warning(f"queued-{name}")
            pkg.flush_logs()
            assert f"queued-{name}" in log_file.read_text()
            assert pkg._LISTENER is not None  # the sink goes on
            logger.warning(f"again-{name}")
            pkg.flush_logs()
            assert f"again-{name}" in log_file.read_text()
        finally:  # the logger as the rest of the suite had it
            pkg._stop_listener()
            root.handlers[:], root.level, root.propagate, pkg._CONFIGURED = saved
    tlog.flush_logs()  # no listener: a no-op


def test_new_rng_keeps_the_jax_contract():
    """n fresh streams, pairwise distinct and distinct from the parent's,
    the same for the same seed (the JAX package: n keys split from one)."""
    keys = np.asarray(jseed.new_rng(jseed.set_seed(5), 3))
    assert keys.shape[0] == 3 and len({k.tobytes() for k in keys}) == 3
    np.testing.assert_array_equal(keys, np.asarray(jseed.new_rng(jseed.set_seed(5), 3)))

    def draws(gens):
        return [torch.rand(4, generator=g).tolist() for g in gens]

    gens = tseed.new_rng(tseed.set_seed(5), 3)
    assert len(gens) == 3 and all(g.device.type == "cpu" for g in gens)
    got = draws(gens)
    assert len({tuple(d) for d in got}) == 3
    assert got == draws(tseed.new_rng(tseed.set_seed(5), 3))
    assert got != draws(tseed.new_rng(tseed.set_seed(6), 3))
    parent = tseed.set_seed(5)
    tseed.new_rng(parent, 3)
    assert torch.rand(4, generator=parent).tolist() not in got


def _hf_bert(seed, V, H=32, inter=64, layers=2, P=40):
    """A synthetic BERT encoder's state dict (f32 numpy) and config."""
    rng = np.random.default_rng(seed)
    w = lambda *shape: (0.2 * rng.standard_normal(shape)).astype(np.float32)  # noqa: E731
    sd = {"bert.embeddings.word_embeddings.weight": w(V, H),
          "bert.embeddings.position_embeddings.weight": w(P, H),
          "bert.embeddings.token_type_embeddings.weight": w(2, H),
          "bert.embeddings.LayerNorm.weight": 1 + w(H), "bert.embeddings.LayerNorm.bias": w(H)}
    for i in range(layers):
        base = f"bert.encoder.layer.{i}"
        for name, shape in (("attention.self.query", (H, H)), ("attention.self.key", (H, H)),
                            ("attention.self.value", (H, H)), ("attention.output.dense", (H, H)),
                            ("intermediate.dense", (inter, H)), ("output.dense", (H, inter))):
            sd[f"{base}.{name}.weight"], sd[f"{base}.{name}.bias"] = w(*shape), w(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{base}.{name}.weight"], sd[f"{base}.{name}.bias"] = 1 + w(H), w(H)
    cfg = {"model_type": "bert", "vocab_size": V, "hidden_size": H, "num_hidden_layers": layers,
           "num_attention_heads": 2, "intermediate_size": inter, "max_position_embeddings": P,
           "type_vocab_size": 2, "layer_norm_eps": 1e-12, "pad_token_id": 0}
    return sd, cfg


def test_convert_bi_encoder_and_the_hf_student_match_jax(tmp_path, jtok):
    """The same synthetic BERT checkpoint through both packages'
    ``convert_bi_encoder``: every parameter equal, bit for bit; the student
    loaded from the HF directory encodes as the JAX package's within 1e-5."""
    sd, cfg = _hf_bert(4, jtok.vocab_size)
    jcfg, tcfg = jconvert.hf_config_to_bert_config(cfg), convert.hf_config_to_bert_config(cfg)
    want, got = jconvert.convert_bi_encoder(sd, jcfg), convert.convert_bi_encoder(sd, tcfg)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    path = tmp_path / "hf"
    path.mkdir()
    (path / "config.json").write_text(json.dumps(cfg))
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path / "pytorch_model.bin")
    js = JStudent(str(path), tokenizer=jtok)
    ts = StudentModel(str(path), device="cpu", tokenizer=WordPieceTokenizer(jtok.vocab))
    assert ts.config.num_layers == 2 and ts.config.hidden_size == 32
    np.testing.assert_allclose(ts.encode(TEXTS), js.encode(TEXTS), rtol=1e-5, atol=1e-5)


def test_metrics_export_every_series_the_alert_rules_name():
    """/metrics of the port's catalog, one request recorded, holds every
    semantic_kd_* series infra/alert_rules.yml reads (histograms as
    _bucket / _count / _sum, counters as _total), and the catalog has the
    JAX package's metric names."""
    from sskd_tpu.serve import metrics as jmetrics

    m = Metrics()
    m.requests_total.labels(method="POST", path="/search", status="200").inc()
    m.request_duration.labels(path="/search").observe(0.01)
    text = m.render().decode()
    series = {line.split("{")[0].split(" ")[0] for line in text.splitlines()
              if line and not line.startswith("#")}
    rules = (ROOT / "infra" / "alert_rules.yml").read_text()
    named = set(re.findall(r"semantic_kd_\w+", rules))
    assert named and named <= series, named - series
    assert "semantic_kd_queries_per_second_chip 0.0" in text
    assert {metric.name for metric in vars(m).values()} == {
        family.name for family in jmetrics.REGISTRY.collect()}
