"""Port vs JAX: the teacher path. Pair framing, the CrossEncoder, the weight
carry-over and the HF converter, TeacherModel's scores, BM25, the teacher's
training triples and its trainer.

Everything runs on the CPU at small sizes: the port with ``device="cpu"``
(its attention wrappers then run their plain versions), JAX with its XLA
attention. Inputs come from numpy seeds and go to both. The teacher config
is bge-reranker-large's in kind at a small width: 2 layers, hidden 128, 2
heads (head dim 64, the teacher's), roberta positions, ``pad_token_id`` 1,
``type_vocab_size`` 1 (so the pair framing's type-1 tokens read row 0).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sskd_tpu.kd.teacher_train import TeacherTrainer as JTrainer
from sskd_tpu.kd.teacher_train import triples_from_raw as j_triples
from sskd_tpu.mining.bm25 import BM25Index as JBM25
from sskd_tpu.models import convert as jconvert
from sskd_tpu.models.bert import BertConfig as JConfig, CrossEncoder as JCrossEncoder
from sskd_tpu.models.teacher import TeacherModel as JTeacher
from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu_torch.exceptions import ChecksumMismatchError, ModelLoadError, WeightConversionError
from sskd_tpu_torch.kd.teacher_train import TeacherTrainer, triples_from_raw
from sskd_tpu_torch.mining.bm25 import BM25Index
from sskd_tpu_torch.models import bert, convert
from sskd_tpu_torch.models.bert import BertConfig, CrossEncoder
from sskd_tpu_torch.models.teacher import TeacherModel
from sskd_tpu_torch.models.weights import cross_encoder_from_jax_params, random_jax_params
from sskd_tpu_torch.ops import attention as ta
from sskd_tpu_torch.tokenization import WordPieceTokenizer

WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu nu xi omicron "
         "pi rho sigma tau upsilon phi chi psi omega what is the of a find about").split()
ARCH = dict(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
            max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5,
            pad_token_id=1, position_style="roberta")


def _text(rng, lo, hi):
    return " ".join(rng.choice(WORDS, int(rng.integers(lo, hi + 1))))


def _pairs(seed, n, lo=2, hi=60):
    rng = np.random.default_rng(seed)
    return [(_text(rng, 2, 8), _text(rng, lo, hi)) for _ in range(n)]


@pytest.fixture(scope="module")
def jtok():
    return JTokenizer.build_from_corpus([" ".join(WORDS)], vocab_size=256)


@pytest.fixture(scope="module")
def tok(jtok):
    return WordPieceTokenizer(jtok.vocab)


def _configs(vocab_size, **kw):
    return JConfig(vocab_size=vocab_size, **ARCH, **kw), BertConfig(vocab_size=vocab_size,
                                                                    **ARCH, **kw)


@pytest.fixture(scope="module")
def jparams(jtok):
    jcfg, _ = _configs(jtok.vocab_size)
    dummy = np.zeros((1, 8), np.int32)
    params = JCrossEncoder(jcfg).init(jax.random.PRNGKey(3), dummy, np.ones_like(dummy))
    return jax.tree_util.tree_map(np.asarray, params)


# ---------------------------------------------------------------------------
# Pair framing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_length,pad_to,lo,hi", [
    (64, None, 2, 20),     # no truncation
    (32, None, 20, 60),    # the passage is cut
    (16, 16, 2, 60),       # both sides may be cut, the longer first
    (24, 32, 10, 12),      # pad_to past max_length
])
def test_encode_batch_pairs_match_jax(jtok, tok, max_length, pad_to, lo, hi):
    rng = np.random.default_rng(max_length)
    a = [_text(rng, 1, 14) for _ in range(7)] + ["zeta " * 30]
    b = [_text(rng, lo, hi) for _ in range(7)] + ["eta"]
    want = jtok.encode_batch(a, text_pairs=b, max_length=max_length, pad_to=pad_to)
    got = tok.encode_batch(a, text_pairs=b, max_length=max_length, pad_to=pad_to)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    with pytest.raises(ValueError):
        tok.encode_batch(a, text_pairs=b[:-1])


# ---------------------------------------------------------------------------
# CrossEncoder and the weight carry-over
# ---------------------------------------------------------------------------


def _jax_logits(params, jcfg, batch):
    return np.asarray(JCrossEncoder(jcfg).apply(params, batch["input_ids"],
                                                batch["attention_mask"],
                                                batch["token_type_ids"]))


def _port_logits(model, batch):
    with torch.no_grad():
        return model(*(torch.from_numpy(batch[k]).long()
                       for k in ("input_ids", "attention_mask", "token_type_ids"))).numpy()


# f32: summation order through two layers (1e-5 relative, 1e-6 absolute
# for logits near 0). bf16: each side rounds activations and weights to bf16
# (2^-8 relative) in different places (XLA fuses, torch does not), which
# moves a logit of magnitude ~1 by a few bf16 ulps of the pooled activations:
# 0.05 absolute plus 5 % relative.
@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-5, 1e-6), ("bfloat16", 5e-2, 5e-2)])
@pytest.mark.parametrize("L", [64, 512])  # 512: the port's flash path
def test_cross_encoder_logits_match_jax(jtok, tok, jparams, dtype, rtol, atol, L):
    jcfg = JConfig(vocab_size=jtok.vocab_size, **ARCH, compute_dtype=getattr(jnp, dtype))
    cfg = BertConfig(vocab_size=jtok.vocab_size, **ARCH, compute_dtype=getattr(torch, dtype))
    pairs = _pairs(L, 6, hi=L)
    batch = jtok.encode_batch([q for q, _ in pairs], text_pairs=[d for _, d in pairs],
                              max_length=L)
    assert batch["token_type_ids"].max() == 1  # type-1 tokens read row 0 of a 1-row table
    model = CrossEncoder(cfg).eval()
    model.load_state_dict(cross_encoder_from_jax_params(jparams, cfg))
    got = _port_logits(model, batch)
    assert got.dtype == np.float32 and got.shape == (6,)
    np.testing.assert_allclose(got, _jax_logits(jparams, jcfg, batch), rtol=rtol, atol=atol)


def test_random_params_have_the_cross_encoder_head(jtok, jparams):
    _, cfg = _configs(jtok.vocab_size)
    tree = random_jax_params(cfg, seed=5, cross_encoder=True)
    shapes = jax.tree_util.tree_map(np.shape, tree)
    assert shapes == jax.tree_util.tree_map(np.shape, jparams)
    # the head is drawn after the encoder: the encoder is the bi-encoder's
    plain = random_jax_params(cfg, seed=5)
    for a, b in zip(jax.tree_util.tree_leaves(plain), jax.tree_util.tree_leaves(
            {"params": {"encoder": tree["params"]["encoder"]}})):
        np.testing.assert_array_equal(a, b)
    model = CrossEncoder(cfg)
    model.load_state_dict(cross_encoder_from_jax_params(tree, cfg))  # strict: every key


# ---------------------------------------------------------------------------
# The HF converter
# ---------------------------------------------------------------------------


def _hf_state_dict(seed, V=40, H=32, inter=64, layers=2, P=20):
    """A synthetic XLM-R sequence classifier's state dict (f32 numpy)."""
    rng = np.random.default_rng(seed)
    w = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    sd = {"roberta.embeddings.word_embeddings.weight": w(V, H),
          "roberta.embeddings.position_embeddings.weight": w(P, H),
          "roberta.embeddings.token_type_embeddings.weight": w(1, H),
          "roberta.embeddings.LayerNorm.weight": w(H), "roberta.embeddings.LayerNorm.bias": w(H)}
    for i in range(layers):
        base = f"roberta.encoder.layer.{i}"
        for name, shape in (("attention.self.query", (H, H)), ("attention.self.key", (H, H)),
                            ("attention.self.value", (H, H)), ("attention.output.dense", (H, H)),
                            ("intermediate.dense", (inter, H)), ("output.dense", (H, inter))):
            sd[f"{base}.{name}.weight"], sd[f"{base}.{name}.bias"] = w(*shape), w(shape[0])
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[f"{base}.{name}.weight"], sd[f"{base}.{name}.bias"] = w(H), w(H)
    sd["classifier.dense.weight"], sd["classifier.dense.bias"] = w(H, H), w(H)
    sd["classifier.out_proj.weight"], sd["classifier.out_proj.bias"] = w(1, H), w(1)
    cfg = {"model_type": "xlm-roberta", "vocab_size": V, "hidden_size": H,
           "num_hidden_layers": layers, "num_attention_heads": 2, "intermediate_size": inter,
           "max_position_embeddings": P, "type_vocab_size": 1, "layer_norm_eps": 1e-5,
           "pad_token_id": 1}
    return sd, cfg


def _write_hf(path, sd, cfg, fmt):
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path / "pytorch_model.bin")
    else:
        from safetensors.numpy import save_file

        save_file(sd, str(path / "model.safetensors"))
    return path


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_hf_converter_matches_jax(tmp_path, fmt):
    """The same synthetic checkpoint through JAX's load_hf_checkpoint and
    convert_cross_encoder and through the port's (its own safetensors
    reader): the same config and every parameter equal, bit for bit."""
    sd, cfg = _hf_state_dict(1)
    path = _write_hf(tmp_path / fmt, sd, cfg, fmt)
    jsd, jcfg_dict = jconvert.load_hf_checkpoint(path)
    tsd, tcfg_dict = convert.load_hf_checkpoint(path)
    assert jcfg_dict == tcfg_dict
    jcfg = jconvert.hf_config_to_bert_config(jcfg_dict)
    tcfg = convert.hf_config_to_bert_config(tcfg_dict)
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads", "intermediate_size",
                  "max_position_embeddings", "type_vocab_size", "layer_norm_eps",
                  "pad_token_id", "position_style"):
        assert getattr(jcfg, field) == getattr(tcfg, field), field
    want = jconvert.convert_cross_encoder(jsd, jcfg)
    got = convert.convert_cross_encoder(tsd, tcfg)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


def test_hf_checkpoint_scores_match_jax(tmp_path, jtok, tok):
    """TeacherModel over an HF directory in both packages: the same scores."""
    sd, cfg = _hf_state_dict(2, V=jtok.vocab_size, P=80)
    path = _write_hf(tmp_path / "hf", sd, cfg, "safetensors")
    pairs = _pairs(4, 5, hi=20)
    want = JTeacher(str(path), tokenizer=jtok).score(pairs)
    got = TeacherModel(str(path), device="cpu", tokenizer=tok).score(pairs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_safetensors_reader_reads_bf16_as_bits(tmp_path):
    from safetensors.torch import save_file

    t = torch.randn(5, 7).to(torch.bfloat16)
    save_file({"w": t, "i": torch.arange(6, dtype=torch.int64).view(2, 3)},
              str(tmp_path / "m.safetensors"))
    bits = convert.read_safetensors(tmp_path / "m.safetensors")
    np.testing.assert_array_equal(bits["w"], t.view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(bits["i"], np.arange(6).reshape(2, 3))
    # the converter widens the bits to the f32 values, exactly
    np.testing.assert_array_equal(convert._t(bits["w"]), t.float().numpy())


def test_safetensors_reader_on_a_handwritten_file(tmp_path):
    """The format written out by hand: header length, JSON header, buffers;
    a header that runs past the data is refused."""
    a = np.arange(12, dtype="<f4").reshape(3, 4)
    header = json.dumps({"__metadata__": {"format": "pt"},
                         "a": {"dtype": "F32", "shape": [3, 4], "data_offsets": [0, 48]}})
    raw = len(header).to_bytes(8, "little") + header.encode() + a.tobytes()
    (tmp_path / "ok.safetensors").write_bytes(raw)
    np.testing.assert_array_equal(convert.read_safetensors(tmp_path / "ok.safetensors")["a"], a)
    (tmp_path / "bad.safetensors").write_bytes(raw[:-4])
    with pytest.raises(WeightConversionError):
        convert.read_safetensors(tmp_path / "bad.safetensors")


def test_hf_converter_refuses_a_missing_head(tmp_path):
    sd, cfg = _hf_state_dict(3)
    del sd["classifier.out_proj.weight"], sd["classifier.out_proj.bias"]
    with pytest.raises(WeightConversionError, match="head"):
        convert.convert_cross_encoder(sd, convert.hf_config_to_bert_config(cfg))
    with pytest.raises(WeightConversionError, match="no weights"):
        (tmp_path / "config.json").write_text(json.dumps(cfg))
        convert.load_hf_checkpoint(tmp_path)


# ---------------------------------------------------------------------------
# TeacherModel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def teachers(jtok, tok, jparams):
    jcfg, cfg = _configs(jtok.vocab_size)
    jt = JTeacher("tiny-teacher", config=jcfg, tokenizer=jtok, params=jparams)
    tt = TeacherModel("tiny-teacher", device="cpu", config=cfg, tokenizer=tok, params=jparams)
    return jt, tt


def test_teacher_score_matches_jax(teachers):
    """Chunks of 4 pairs of mixed lengths, so the chunks fall in different
    buckets (up to 512, where the port takes its flash path): the same
    logits, f32 summation order (1e-5)."""
    jt, tt = teachers
    pairs = _pairs(9, 10, hi=30) + _pairs(10, 3, lo=400, hi=600)
    want = jt.score(pairs, batch_size=4)
    got = tt.score(pairs, batch_size=4)
    assert isinstance(got, list) and len(got) == len(pairs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert tt.score([]) == []


def test_confidence_predict_score_and_save_load(tmp_path, teachers):
    jt, tt = teachers
    pairs = _pairs(11, 5)
    for s in (-3.0, 0.0, 0.7, 12.0):
        assert tt.get_confidence(s) == jt.get_confidence(s)
    assert tt.get_confidence(0.0) == 0.5
    scores = tt.score(pairs)
    assert tt.predict(pairs) == scores
    assert tt.predict_score(*pairs[2]) == pytest.approx(scores[2], rel=1e-6, abs=1e-7)
    out = tt.save(tmp_path / "teacher")
    meta = json.loads((out / "sskd_config.json").read_text())
    jmeta = json.loads((jt.save(tmp_path / "jteacher") / "sskd_config.json").read_text())
    assert meta == {**jmeta, "model_name": meta["model_name"]}
    back = TeacherModel(str(out), device="cpu")
    assert back.config == tt.config and back.tokenizer.vocab == tt.tokenizer.vocab
    assert back.score(pairs) == scores


def test_unreadable_checkpoints_raise_load_errors(tmp_path, teachers):
    """A JAX checkpoint directory (params.msgpack) loads and scores as the
    JAX teacher does (1e-5); a truncated params.msgpack or weights.pt raises
    ModelLoadError, a missing weights file OSError."""
    jt, tt = teachers
    jax_dir = jt.save(tmp_path / "jax_format")
    pairs = _pairs(12, 6)
    loaded = TeacherModel(str(jax_dir), device="cpu")
    np.testing.assert_allclose(loaded.score(pairs), jt.score(pairs), rtol=1e-5, atol=1e-5)
    raw = (jax_dir / "params.msgpack").read_bytes()
    (jax_dir / "params.msgpack").write_bytes(raw[: len(raw) // 2])
    with pytest.raises(ModelLoadError, match="truncated"):
        TeacherModel(str(jax_dir), device="cpu")
    own = tt.save(tmp_path / "own")
    raw = (own / "weights.pt").read_bytes()
    (own / "weights.pt").write_bytes(raw[: len(raw) // 2])
    with pytest.raises(ModelLoadError, match="cannot read"):
        TeacherModel(str(own), device="cpu")
    (own / "weights.pt").unlink()
    with pytest.raises(OSError):
        TeacherModel(str(own), device="cpu")


def test_teacher_and_trainer_default_to_cuda(monkeypatch, tok):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TeacherModel("tiny-teacher", tokenizer=tok)
    with pytest.raises(RuntimeError, match="CUDA"):
        TeacherTrainer(TeacherModel("tiny-teacher", tokenizer=tok))


# ---------------------------------------------------------------------------
# BM25 and the training triples
# ---------------------------------------------------------------------------


def _corpus(seed, n):
    rng = np.random.default_rng(seed)
    return [_text(rng, 3, 40) for _ in range(n)]


def test_bm25_matches_jax(tmp_path):
    docs = _corpus(1, 300) + ["alpha alpha alpha", "Alpha BETA"]
    ids = [f"d{i}" for i in range(len(docs))]
    jidx, tidx = JBM25().build(docs, ids), BM25Index().build(docs, ids)
    for q in ["alpha beta", "omega omega pi", "nothing here", "ALPHA", _text(np.random.
              default_rng(2), 5, 9)]:
        np.testing.assert_array_equal(tidx.get_scores(q), jidx.get_scores(q))
        assert tidx.search(q, k=7) == jidx.search(q, k=7)
    assert tidx.batch_search(["pi rho", "tau"], k=3) == jidx.batch_search(["pi rho", "tau"], k=3)
    # the files are the JAX package's: each package loads the other's
    tidx.save(tmp_path / "port")
    jidx.save(tmp_path / "jax")
    assert JBM25.exists(tmp_path / "port")
    for name in ("doc_ids.json", "tokenized_corpus.json", "bm25_params.json", "checksum.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    back = BM25Index.load(tmp_path / "jax")
    np.testing.assert_array_equal(back.get_scores("alpha beta"), jidx.get_scores("alpha beta"))
    (tmp_path / "port" / "doc_ids.json").write_text(json.dumps(ids[::-1]))
    with pytest.raises(ChecksumMismatchError):
        BM25Index.load(tmp_path / "port")


def _write_raw(path, seed, n_rows=40):
    """MS-MARCO-shaped raw JSONL: the nested v2.1 layout and the list
    layout, one or two selected passages a row, a row with none."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n_rows):
            texts = [_text(rng, 5, 30) for _ in range(int(rng.integers(3, 8)))]
            sel = [0] * len(texts)
            if i % 7:
                sel[int(rng.integers(len(texts)))] = 1
            if i % 5 == 0:
                sel[0] = 1
            query = _text(rng, 2, 6)
            if i % 2:
                row = {"query": query, "passages": {"passage_text": texts, "is_selected": sel}}
            else:
                row = {"query": query, "passages": [{"passage_text": t, "is_selected": s}
                                                    for t, s in zip(texts, sel)]}
            f.write(json.dumps(row) + "\n")
    return path


@pytest.mark.parametrize("kw", [{}, {"hard_negatives_per_query": 0},
                                {"max_samples": 11, "seed": 4}])
def test_triples_from_raw_match_jax(tmp_path, kw):
    raw = _write_raw(tmp_path / "train.jsonl", 7)
    want = j_triples(raw, **kw)
    got = triples_from_raw(raw, **kw)
    assert got == want
    assert {lab for _, _, lab in got} == {0.0, 1.0}


# ---------------------------------------------------------------------------
# TeacherTrainer
# ---------------------------------------------------------------------------


def test_three_teacher_train_steps_match_jax(tmp_path, jtok, tok, jparams):
    """Three steps of both trainers at dropout 0 from the same parameters on
    the same triples: the same rows are drawn, the losses agree to f32
    summation order (rel 1e-5), the held-out pair accuracy is the same, and
    so are the parameters after the steps to 1e-5 (absolute), but where a
    gradient is rounding noise: AdamW moves an element by about lr a step
    whatever its gradient's size, so such elements may move apart by up to
    1.5 x (lr_2 + lr_3); fewer than 0.1 % of them do (0.015 % here)."""
    raw = _write_raw(tmp_path / "train.jsonl", 3)
    triples = j_triples(raw)
    jcfg, cfg = _configs(jtok.vocab_size, hidden_dropout=0.0, attention_dropout=0.0)
    lr = 1e-3
    jt = JTeacher("tiny-teacher", config=jcfg, tokenizer=jtok, params=jparams)
    tt = TeacherModel("tiny-teacher", device="cpu", config=cfg, tokenizer=tok, params=jparams)
    kw = dict(steps=3, batch_size=8, max_len=48)
    want = JTrainer(jt, learning_rate=lr, seed=0).train(triples, **kw)
    got = TeacherTrainer(tt, learning_rate=lr, seed=0).train(triples, **kw)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["heldout_pair_accuracy"] == want["heldout_pair_accuracy"]
    jsd = cross_encoder_from_jax_params(jax.tree_util.tree_map(np.asarray, jt.params), cfg)
    step_lrs = [0.0, lr, lr / 2]  # a warmup of 1 step, then a linear decay over 2
    n_far, n_all = 0, 0
    for name, p in tt.module.state_dict().items():
        diff = (p - jsd[name]).abs()
        assert diff.max().item() <= 1.5 * sum(step_lrs), name
        n_far += int((diff > 1e-5).sum())
        n_all += diff.numel()
    assert n_far / n_all < 0.001


def test_first_step_leaves_the_parameters(jtok, tok, jparams, tmp_path):
    """optax reads the schedule before the update: the first step's rate is
    0, so one step leaves every parameter bit for bit."""
    _, cfg = _configs(jtok.vocab_size)
    tt = TeacherModel("tiny-teacher", device="cpu", config=cfg, tokenizer=tok, params=jparams)
    before = {k: v.clone() for k, v in tt.module.state_dict().items()}
    triples = j_triples(_write_raw(tmp_path / "t.jsonl", 5))
    TeacherTrainer(tt, seed=1).train(triples, steps=1, batch_size=4, max_len=32)
    assert all(torch.equal(v, before[k]) for k, v in tt.module.state_dict().items())


def test_dropout_gradients_through_the_kernels_plain_versions(jtok, jparams):
    """Dropout live, no remat: the gradients of a CrossEncoder step through
    dropout_attention (on the CPU its wrappers run dropattn_fwd_plain and
    dropattn_bwd_plain) equal those of the materialised path
    (dropout_attention_plain, autograd through the explicit keep-mask) for
    the same masks, to f32 summation order."""
    _, cfg = _configs(jtok.vocab_size)
    model = CrossEncoder(cfg)
    model.load_state_dict(cross_encoder_from_jax_params(jparams, cfg))
    model.train()
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(5, jtok.vocab_size, (4, 40)))
    mask = torch.ones_like(ids)
    mask[1, 30:] = 0
    types = (torch.arange(40)[None, :] >= 12).long().expand(4, 40)
    labels = torch.tensor([1.0, 0.0, 0.0, 1.0])

    def grads():
        model.zero_grad()
        logits = model(ids, mask, types, dropout_seed=7)
        torch.nn.functional.binary_cross_entropy_with_logits(logits, labels).backward()
        return torch.cat([p.grad.flatten() for p in model.parameters()])

    through_kernels = grads()
    real = bert.dropout_attention
    bert.dropout_attention = ta.dropout_attention_plain
    try:
        materialised = grads()
    finally:
        bert.dropout_attention = real
    scale = materialised.abs().max().item()
    assert (through_kernels - materialised).abs().max().item() <= 1e-5 * scale
    # dropout is live: another seed gives other gradients
    model.zero_grad()
    torch.nn.functional.binary_cross_entropy_with_logits(
        model(ids, mask, types, dropout_seed=8), labels).backward()
    other = torch.cat([p.grad.flatten() for p in model.parameters()])
    assert (other - through_kernels).abs().max().item() > 1e-3 * scale


def test_trainer_learns(tmp_path, jtok, tok, jparams):
    triples = j_triples(_write_raw(tmp_path / "t.jsonl", 6, n_rows=60))
    _, cfg = _configs(jtok.vocab_size)
    tt = TeacherModel("tiny-teacher", device="cpu", config=cfg, tokenizer=tok, params=jparams)
    result = TeacherTrainer(tt, learning_rate=1e-3).train(triples, steps=30, batch_size=16,
                                                          max_len=48)
    assert np.mean(result["losses"][-5:]) < np.mean(result["losses"][:5])
    assert 0.0 <= result["heldout_pair_accuracy"] <= 1.0 and not tt.module.training
