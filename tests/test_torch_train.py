"""Port vs JAX: KD losses, batch packing, the optimizer and the train step;
and the port's trainer on its own (remat, resume, early stopping, dtypes).

Everything runs on the CPU at tiny sizes: the port with ``device="cpu"``
(its dropattn wrappers then run their plain versions), JAX with its
materialized attention. Inputs come from numpy seeds and go to both.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sskd_tpu.config import Settings as JSettings
from sskd_tpu.kd import losses as jl
from sskd_tpu.kd.dataset import KDDataset as JDataset, KDSample as JSample
from sskd_tpu.kd.train import KDTrainer as JTrainer
from sskd_tpu.models.bert import BertConfig as JConfig, BiEncoder as JBiEncoder
from sskd_tpu.models.student import StudentModel as JStudent
from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu_torch.config import Settings
from sskd_tpu_torch.exceptions import ConfigError
from sskd_tpu_torch.kd import losses as tl
from sskd_tpu_torch.kd.dataset import KDDataset, KDSample
from sskd_tpu_torch.kd.train import KDOptimizer, KDTrainer
from sskd_tpu_torch.models.bert import BertConfig, BiEncoder
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.models.weights import bi_encoder_from_jax_params
from sskd_tpu_torch.tokenization import WordPieceTokenizer

WORDS = "alpha beta gamma delta epsilon zeta eta theta iota kappa".split()


def _make_samples(n=16, n_docs=4, seed=0, cls=KDSample):
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(n):
        topic = WORDS[i % len(WORDS)]
        negs = [f"{WORDS[(i + j + 1) % len(WORDS)]} unrelated text" for j in range(n_docs - 1)]
        scores = [5.0] + sorted(rng.uniform(-5, 0, n_docs - 1).tolist(), reverse=True)
        samples.append(cls(query=f"find {topic} info",
                           docs=[f"{topic} {topic} document about {topic}"] + negs,
                           teacher_scores=scores))
    return samples


@pytest.fixture(scope="module")
def jtok():
    texts = [" ".join(WORDS), "find info document about unrelated text query passage"]
    return JTokenizer.build_from_corpus(texts, vocab_size=512)


@pytest.fixture(scope="module")
def tok(jtok):
    return WordPieceTokenizer(jtok.vocab)


def _student(tok, **cfg):
    return StudentModel("tiny-train", device="cpu",
                        config=BertConfig.tiny(vocab_size=tok.vocab_size, **cfg), tokenizer=tok)


def _settings(**training):
    base = {"epochs": 2, "batch_size": 4, "learning_rate": 5e-3, "warmup_ratio": 0.1,
            "early_stopping_patience": 10, "num_docs_per_query": 4}
    base.update(training)
    return Settings.from_dict({"training": base})


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _loss_inputs(seed, B=5, N=6):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((B, N)).astype(np.float32)
    t = (3 * rng.standard_normal((B, N))).astype(np.float32)
    mask = (rng.uniform(size=(B, N)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[-1] = 0.0  # a batch-tail padding row
    return s, t, mask


@pytest.mark.parametrize("name", ["margin_mse_loss", "listwise_kd_loss"])
@pytest.mark.parametrize("masked", [False, True])
def test_distillation_losses_match_jax(name, masked):
    s, t, mask = _loss_inputs(1)
    m = mask if masked else None
    want = float(getattr(jl, name)(jnp.asarray(s), jnp.asarray(t),
                                   None if m is None else jnp.asarray(m), 2.5))
    got = float(getattr(tl, name)(torch.from_numpy(s), torch.from_numpy(t),
                                  None if m is None else torch.from_numpy(m), 2.5))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_contrastive_loss_matches_jax(masked):
    s, _, mask = _loss_inputs(2)
    m = mask if masked else None
    want = float(jl.contrastive_loss(jnp.asarray(s), None if m is None else jnp.asarray(m), 0.05))
    got = float(tl.contrastive_loss(torch.from_numpy(s), None if m is None else torch.from_numpy(m),
                                    0.05))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("wide", [False, True])
def test_combined_loss_matches_jax(wide):
    s, t, mask = _loss_inputs(3)
    kw = {}
    if wide:  # in-batch negatives: a wider InfoNCE matrix and its mask
        ws, _, wm = _loss_inputs(4, N=18)
        ws[:, :6], wm[:, :6] = s, mask
        kw = {"contrastive_scores": ws, "contrastive_mask": wm}
    want = jl.combined_kd_loss(jnp.asarray(s), jnp.asarray(t), jnp.asarray(mask), temperature=3.0,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tl.combined_kd_loss(torch.from_numpy(s), torch.from_numpy(t), torch.from_numpy(mask),
                              temperature=3.0, **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert set(got) == set(want)
    for key in want:
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6, abs=1e-6), key


@pytest.mark.parametrize("progress", [-0.5, 0.0, 0.3, 1.0, 2.0])
def test_temperature_matches_jax(progress):
    assert tl.temperature_at(progress) == pytest.approx(float(jl.temperature_at(progress)), abs=1e-7)


# ---------------------------------------------------------------------------
# Tokenizer and batch packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_length,pad_to", [(16, None), (6, None), (8, 12)])
def test_encode_batch_matches_jax(jtok, tok, max_length, pad_to):
    texts = ["query: find alpha info", "passage: " + " ".join(WORDS), "", "ünïcode kappa!"]
    want = jtok.encode_batch(texts, max_length=max_length, pad_to=pad_to)
    got = tok.encode_batch(texts, max_length=max_length, pad_to=pad_to)
    for key in ("input_ids", "attention_mask", "token_type_ids"):
        np.testing.assert_array_equal(got[key], want[key])
        assert got[key].dtype == want[key].dtype


@pytest.mark.parametrize("n", [8, 14])  # 14: a repeat-padded last batch
def test_kd_batches_match_jax(jtok, tok, n):
    kw = dict(num_docs=5, query_len=12, doc_len=10)
    want = list(JDataset(_make_samples(n, 4, cls=JSample), jtok, **kw).batches(4, seed=3))
    got = list(KDDataset(_make_samples(n, 4), tok, **kw).batches(4, seed=3))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_optax(accum):
    """KDOptimizer against the optax chain the JAX trainer builds
    (clip_by_global_norm, adamw on the warmup-decay schedule, MultiSteps),
    fed the same gradients: some above the clip norm, some below."""
    rng = np.random.default_rng(accum)
    p0 = rng.standard_normal(7).astype(np.float32)
    grads = [(rng.standard_normal(7) * s).astype(np.float32) for s in (3.0, 0.05, 1.0, 0.2) * 2]
    settings = _settings(grad_accum_steps=accum, learning_rate=1e-2, weight_decay=0.1)
    total = len(grads)
    jt = JTrainer(None, JSettings.model_validate({"training": {
        "grad_accum_steps": accum, "learning_rate": 1e-2, "weight_decay": 0.1}}))
    tx = jt._make_optimizer(total)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = KDOptimizer([param], settings.training, total)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.begin()
        param.grad = torch.from_numpy(g.copy()) if param.grad is None else param.grad + torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    assert opt.updates == total // accum


def test_schedule_matches_optax():
    settings = _settings(learning_rate=3e-4, warmup_ratio=0.25)
    opt = KDOptimizer([torch.nn.Parameter(torch.zeros(1))], settings.training, 20)
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, 3e-4, 5), optax.linear_schedule(3e-4, 0.0, 15)], [5])
    for count in range(25):
        assert opt.schedule(count) == pytest.approx(float(sched(count)), rel=1e-6, abs=1e-12)


# ---------------------------------------------------------------------------
# The train step against JAX
# ---------------------------------------------------------------------------


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_three_train_steps_match_jax(jtok, tok):
    """Three steps of the JAX train step (_make_optimizer + _build_train_step)
    and of the port's, f32, dropout 0, remat off, from the same parameters
    on the same batches. The first update is zero on both sides (optax takes
    the rate at the count before the update, and the warmup starts at 0).
    The second and third move every parameter by about the rate: where a
    gradient is near zero, Adam normalises rounding noise, so an element may
    move up to 1.5 x (lr_2 + lr_3) apart on the two sides; all but 0.5% of
    the elements agree to 1e-4 of the rate."""
    lr = 1e-3
    training = {"epochs": 1, "batch_size": 4, "learning_rate": lr, "num_docs_per_query": 4,
                "remat": False}
    jcfg = JConfig.tiny(vocab_size=jtok.vocab_size, hidden_dropout=0.0, attention_dropout=0.0)
    js = JStudent(model_name="tiny-parity", config=jcfg, tokenizer=jtok, seed=1)
    jt = JTrainer(js, JSettings.model_validate({"training": training}))
    total = 3
    jt._tx = jt._make_optimizer(total)
    jt._train_step = jt._build_train_step()
    params = jax.tree_util.tree_map(jnp.copy, js.params)
    start = _numpy_tree(params)
    opt_state = jt._tx.init(params)
    kw = dict(num_docs=4, query_len=12, doc_len=12)
    jbatches = list(JDataset(_make_samples(12, cls=JSample), jtok, **kw).batches(4, seed=0))
    tbatches = list(KDDataset(_make_samples(12), tok, **kw).batches(4, seed=0))

    ts = StudentModel("tiny-parity", device="cpu", tokenizer=tok, params=start,
                      config=BertConfig.tiny(vocab_size=tok.vocab_size, hidden_dropout=0.0,
                                             attention_dropout=0.0))
    tt = KDTrainer(ts, Settings.from_dict({"training": training}))
    tt._opt = tt._make_optimizer(total)
    tt._prepare_module()
    start_sd = {k: v.clone() for k, v in ts.module.state_dict().items()}

    for i in range(total):
        progress = i / max(1, total - 1)
        params, opt_state, jaux = jt._train_step(params, opt_state, jbatches[i],
                                                 jnp.float32(progress), jax.random.PRNGKey(0))
        taux = tt._train_step(tbatches[i], progress, 0)
        # step 1 from equal parameters: f32 summation order; steps 2 and 3
        # from parameters up to 1.5 x lr apart (see above): 2e-4
        rel = 2e-6 if i == 0 else 2e-4
        for key in ("loss", "margin_mse", "listwise_kd", "contrastive"):
            assert float(taux[key]) == pytest.approx(float(jaux[key]), rel=rel, abs=1e-6), (i, key)
        if i == 0:
            # the step-1 update is zero on both sides
            jsd = bi_encoder_from_jax_params(_numpy_tree(params), ts.config)
            sd = ts.module.state_dict()
            for name, want in start_sd.items():
                assert torch.equal(sd[name], want), name
                assert torch.equal(jsd[name], want), name
            # step-1 gradients (after clipping): Adam's first moment is
            # (1 - b1) g on both sides
            adam = [x for x in jax.tree_util.tree_leaves(
                opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu")][0]
            jgrad = bi_encoder_from_jax_params(
                jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, adam.mu), ts.config)
            for name, p in ts.module.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), jgrad[name].numpy(),
                                           rtol=1e-4, atol=1e-7, err_msg=name)
    jsd = bi_encoder_from_jax_params(_numpy_tree(params), ts.config)
    lrs = [tt._opt.schedule(c) for c in range(total)]
    assert lrs[0] == 0.0 and lrs[1] == lr
    moved_apart = 1.5 * (lrs[1] + lrs[2])
    n_far, n_all = 0, 0
    for name, p in ts.module.state_dict().items():
        diff = (p - jsd[name]).abs()
        assert diff.max().item() <= moved_apart, name
        n_far += int((diff > 1e-4 * lr).sum())
        n_all += diff.numel()
    assert n_far / n_all < 0.005


# ---------------------------------------------------------------------------
# The port's trainer
# ---------------------------------------------------------------------------


def test_bf16_compute_keeps_f32_params_and_matches_jax(tok):
    """compute_dtype bf16: the parameters stay f32 (AdamW at lr 2e-5 needs
    them: most updates fall below bf16's resolution) and each op rounds the
    weights as Flax's dtype= does. Against the Flax BiEncoder in bf16: both
    round every op's output to bf16 but in different places (torch's matmul
    rounds once after the bias, XLA before), so embeddings agree to 2e-2."""
    cfg = JConfig.tiny(vocab_size=tok.vocab_size, compute_dtype=jnp.bfloat16)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, tok.vocab_size, (3, 24)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 10:] = 0
    jm = JBiEncoder(cfg)
    params = jm.init(jax.random.PRNGKey(1), ids, mask)
    want = np.asarray(jm.apply(params, ids, mask))
    st = StudentModel("tiny", device="cpu", tokenizer=tok, params=_numpy_tree(params),
                      config=BertConfig.tiny(vocab_size=tok.vocab_size),
                      compute_dtype=torch.bfloat16)
    assert st.config.compute_dtype == torch.bfloat16
    assert {p.dtype for p in st.module.parameters()} == {torch.float32}
    got = st.forward_batch({"input_ids": ids, "attention_mask": mask}).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2)


def test_loss_decreases(tok, tmp_path):
    trainer = KDTrainer(_student(tok), _settings())
    result = trainer.train(_make_samples(16), output_dir=tmp_path / "run", query_len=16,
                           doc_len=16)
    hist = result["history"]
    assert len(hist) == 2
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert hist[-1]["temperature"] == pytest.approx(2.0, abs=1e-5)
    assert (tmp_path / "run" / "best_model" / "weights.pt").exists()
    saved = json.loads((tmp_path / "run" / "history.json").read_text())
    assert [h["epoch"] for h in saved] == [1, 2]
    assert set(saved[0]) >= {"epoch", "train_loss", "temperature", "seconds", "margin_mse",
                             "listwise_kd", "contrastive"}
    again = StudentModel(str(tmp_path / "run" / "best_model"), device="cpu")
    assert np.isfinite(again.encode(["find alpha info"])).all()


def test_remat_gives_the_same_gradients_under_dropout(tok):
    """Each layer recomputed under torch.utils.checkpoint draws the same
    dropout masks (attention and hidden) from the seeds passed in, so the
    gradients equal those without remat."""
    ds = KDDataset(_make_samples(4), tok, num_docs=4, query_len=16, doc_len=16)
    batch = next(ds.batches(4, shuffle=False))
    grads = {}
    for remat in (False, True):
        st = _student(tok)
        trainer = KDTrainer(st, _settings(remat=remat))
        trainer._opt = trainer._make_optimizer(10)
        trainer._prepare_module()
        assert st.module.encoder.remat == ("full" if remat else None)
        trainer._train_step(batch, 0.0, 123)
        grads[remat] = {n: p.grad.clone() for n, p in st.module.named_parameters()}
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=0, atol=1e-6)


def test_dropout_is_live_and_seeded(tok):
    ds = KDDataset(_make_samples(4), tok, num_docs=4, query_len=16, doc_len=16)
    batch = next(ds.batches(4, shuffle=False))

    def loss(seed, **cfg):
        trainer = KDTrainer(_student(tok, **cfg), _settings())
        trainer._opt = trainer._make_optimizer(10)
        trainer._prepare_module()
        return float(trainer._train_step(batch, 0.0, seed)["loss"])

    assert loss(1) == loss(1)
    assert loss(1) != loss(2)
    assert loss(1, hidden_dropout=0.0, attention_dropout=0.0) == loss(
        2, hidden_dropout=0.0, attention_dropout=0.0)


def test_remat_policy_dots_trains(tok, tmp_path):
    trainer = KDTrainer(_student(tok), _settings(epochs=1, remat_policy="dots"))
    result = trainer.train(_make_samples(8), output_dir=tmp_path / "dots", query_len=16,
                           doc_len=16)
    assert np.isfinite(result["history"][0]["train_loss"])


def test_resume_restores_step_epoch_and_optimizer(tok, tmp_path):
    out = tmp_path / "resume"
    samples = _make_samples(8)
    st = _student(tok)
    r1 = KDTrainer(st, _settings(epochs=1)).train(samples, output_dir=out, query_len=16,
                                                  doc_len=16)
    assert r1["global_step"] == 2
    ckpt = torch.load(out / "checkpoints" / "step_2" / "state.pt", weights_only=True)
    assert ckpt["step"] == 2 and ckpt["epoch"] == 1 and ckpt["opt_state"]["updates"] == 2

    trainer2 = KDTrainer(_student(tok), _settings(epochs=2))
    trainer2._opt = trainer2._make_optimizer(4)
    restored = trainer2._restore_latest(out)
    assert restored["step"] == 2 and restored["epoch"] == 1
    assert trainer2._opt.updates == 2
    for name, p in trainer2.student.module.named_parameters():
        torch.testing.assert_close(p, dict(st.module.named_parameters())[name], rtol=0, atol=0)
    state = trainer2._opt.adam.state_dict()["state"]
    assert all(int(s["step"]) == 2 for s in state.values())

    r2 = KDTrainer(_student(tok), _settings(epochs=2)).train(samples, output_dir=out,
                                                             query_len=16, doc_len=16)
    assert r2["global_step"] == 4
    assert [h["epoch"] for h in r2["history"]] == [2]


def test_only_the_newest_checkpoints_are_kept(tok, tmp_path):
    trainer = KDTrainer(_student(tok), _settings(epochs=1, save_steps=1, resume=False))
    trainer.train(_make_samples(20), output_dir=tmp_path / "keep", query_len=8, doc_len=8)
    kept = sorted(p.name for p in (tmp_path / "keep" / "checkpoints").iterdir())
    assert kept == ["step_3", "step_4", "step_5"]


def test_in_batch_negatives_padded_tail_batch(tok, tmp_path):
    settings = _settings()
    settings.loss.in_batch_negatives = True
    result = KDTrainer(_student(tok), settings).train(
        _make_samples(14), output_dir=tmp_path / "ibn", query_len=16, doc_len=16)
    hist = result["history"]
    assert all(h["train_loss"] < 1e3 for h in hist)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]


def test_step_evals_drive_best_model(tok, tmp_path, monkeypatch):
    scripted = iter([0.5, 0.9, 0.2, 0.1, 0.3])
    monkeypatch.setattr(KDTrainer, "_dev_ndcg", lambda self, dev: next(scripted, 0.05))
    samples = _make_samples(16)
    result = KDTrainer(_student(tok), _settings(epochs=1, eval_steps=1)).train(
        samples, dev_samples=samples[:4], output_dir=tmp_path / "steps", query_len=16,
        doc_len=16)
    assert result["best_metric"] == pytest.approx(0.9)
    assert [e["step"] for e in result["history"][0]["step_evals"]] == [1, 2, 3, 4]
    assert (tmp_path / "steps" / "best_model" / "weights.pt").exists()


def test_dev_ndcg_is_in_range(tok, tmp_path):
    samples = _make_samples(12)
    result = KDTrainer(_student(tok), _settings(epochs=1)).train(
        samples, dev_samples=samples[:4], output_dir=tmp_path / "dev", query_len=16,
        doc_len=16)
    assert 0.0 <= result["history"][0]["dev_ndcg@10"] <= 1.0


def test_ance_refresh_is_called_at_epoch_boundaries(tok, tmp_path):
    calls = []
    settings = _settings(epochs=3)
    settings.mining.ance_refresh_every_n_steps = 2
    student = _student(tok)
    KDTrainer(student, settings).train(
        _make_samples(8), output_dir=tmp_path / "refresh", query_len=16, doc_len=16,
        negative_refresher=lambda s: calls.append(s) or _make_samples(8, seed=9))
    assert len(calls) == 2 and calls[0] is student


def test_mesh_and_data_parallel_raise(tok):
    """Data-parallel training runs one process per data-axis entry: a data
    axis larger than the world size (1 without a process group) raises,
    naming both numbers and how to start the processes; ``mesh.data_parallel``
    8 loads."""
    from sskd_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(data_parallel=2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ConfigError, match="2 entries but this run has 1 process.*--data-parallel"):
        KDTrainer(_student(tok), mesh=mesh)
    assert Settings.from_dict({"mesh": {"data_parallel": 8}}).mesh.data_parallel == 8


@pytest.mark.parametrize("bad", [
    {"loss": {"margin_mse_weight": 0.5}},
    {"training": {"remat_policy": "some"}},
    {"training": {"learning_rate": 0.0}},
    {"training": {"num_docs_per_query": 1}},
])
def test_training_config_bounds(bad):
    with pytest.raises(ConfigError):
        Settings.from_dict(bad)


@pytest.mark.parametrize("impl", ["threefry2x32", "unsafe_rbg", "mersenne"])
def test_rng_impl_other_than_the_default_raises(impl):
    """The port has no JAX generators: a choice among them would be ignored,
    so it is refused; the default is accepted."""
    assert Settings.from_dict({"training": {"rng_impl": "rbg"}}).training.rng_impl == "rbg"
    with pytest.raises(ConfigError, match="rng_impl"):
        Settings.from_dict({"training": {"rng_impl": impl}})


def test_training_defaults_to_cuda(monkeypatch, tok):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        KDTrainer(StudentModel("tiny", tokenizer=tok))


def test_encode_stays_deterministic_after_training(tok, tmp_path):
    st = _student(tok)
    KDTrainer(st, _settings(epochs=1)).train(_make_samples(8), output_dir=tmp_path / "enc",
                                             query_len=16, doc_len=16)
    assert not st.module.training
    np.testing.assert_array_equal(st.encode(["alpha beta"]), st.encode(["alpha beta"]))


def test_bi_encoder_train_mode_without_seed_is_deterministic(tok):
    model = BiEncoder(BertConfig.tiny(vocab_size=tok.vocab_size)).train()
    ids = torch.randint(5, tok.vocab_size, (2, 12), generator=torch.Generator().manual_seed(0))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        a, b = model(ids, mask), model(ids, mask)
        c = model(ids, mask, dropout_seed=3)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_cached_weight_casts_follow_parameter_updates(tok):
    """With gradients off a module reuses its weights rounded to bf16; an
    in-place update (an optimizer step, load_state_dict) makes a new copy."""
    cfg = BertConfig.tiny(vocab_size=tok.vocab_size, compute_dtype=torch.bfloat16)
    model = BiEncoder(cfg).eval()
    ids = torch.randint(5, tok.vocab_size, (2, 12), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        before = model(ids, mask)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.5)
    fresh = BiEncoder(cfg).eval()
    fresh.load_state_dict(model.state_dict())
    with torch.inference_mode():
        after, want = model(ids, mask), fresh(ids, mask)
    assert not torch.equal(before, after)
    assert torch.equal(after, want)
