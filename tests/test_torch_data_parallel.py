"""Data-parallel KD on torch.distributed: ``initialize_distributed``, the
trainer over a mesh, ``set_mesh`` encoding and ``train --data-parallel``.

One spawn of two gloo processes (tests/torch_dp_worker.py) joins through the
``SSKD_*`` variables, each join bounded by a timeout that fails the test.
Their parameters are held against the port's single-process trainer and the
JAX trainer on ``create_mesh(data_parallel=8)`` (the 8 virtual CPU devices of
tests/conftest.py), from one seeded init carried across by
``models/weights.py``.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dp_worker as worker
from sskd_tpu.config import Settings as JSettings
from sskd_tpu.kd.dataset import KDDataset as JDataset, KDSample as JSample
from sskd_tpu.kd.train import KDTrainer as JTrainer
from sskd_tpu.models.bert import BertConfig as JConfig
from sskd_tpu.models.student import StudentModel as JStudent
from sskd_tpu.parallel.mesh import create_mesh as jcreate_mesh
from sskd_tpu.tokenization import WordPieceTokenizer as JTokenizer
from sskd_tpu_torch.exceptions import ConfigError
from sskd_tpu_torch.kd import losses as tl
from sskd_tpu_torch.kd.dataset import KDDataset
from sskd_tpu_torch.kd.train import KDTrainer
from sskd_tpu_torch.models.bert import BertConfig
from sskd_tpu_torch.models.student import StudentModel
from sskd_tpu_torch.models.weights import bi_encoder_from_jax_params
from sskd_tpu_torch.parallel.distributed import initialize_distributed
from sskd_tpu_torch.parallel.mesh import create_mesh
from sskd_tpu_torch.tokenization import WordPieceTokenizer

ROOT = Path(__file__).resolve().parent.parent
JOIN_TIMEOUT_S = 240  # both ranks, start to exit
CPU2 = [torch.device("cpu")] * 2
# the ranks' summed gradients against one process's, as a share of the
# largest gradient element: f32 summation in another order
GRAD_RTOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jtok():
    texts = [" ".join(worker.WORDS), "find info document about unrelated text query passage"]
    return JTokenizer.build_from_corpus(texts, vocab_size=512)


@pytest.fixture(scope="module")
def init_params(jtok):
    jcfg = JConfig.tiny(vocab_size=jtok.vocab_size, hidden_dropout=0.0, attention_dropout=0.0)
    js = JStudent(model_name="tiny-dp", config=jcfg, tokenizer=jtok, seed=1)
    return jax.tree_util.tree_map(np.asarray, js.params)


def _student(jtok, params, p: float) -> StudentModel:
    tok = WordPieceTokenizer(jtok.vocab)
    cfg = BertConfig.tiny(vocab_size=tok.vocab_size, hidden_dropout=p, attention_dropout=p)
    return StudentModel("tiny-dp", device="cpu", tokenizer=tok, params=params, config=cfg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jtok, init_params):
    """Both ranks' records (tests/torch_dp_worker.py), from one spawn."""
    work = tmp_path_factory.mktemp("dp")
    for name, p in (("init_p0", 0.0), ("init_p1", 0.1)):
        _student(jtok, init_params, p).save(work / name)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "SSKD_COORDINATOR": f"127.0.0.1:{_free_port()}", "SSKD_NUM_PROCESSES": "2"}
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).with_name("torch_dp_worker.py")),
                               str(work)], env={**env, "SSKD_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the two ranks did not finish within {JOIN_TIMEOUT_S} s")
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs[-1:] + logs[:1])
    return [torch.load(work / f"rank_{r}.pt", weights_only=False) for r in (0, 1)]


def test_initialize_distributed_and_the_multihost_collectives(ranks):
    """The join, and scripts/dryrun_multihost.py's values: the sum over
    ranks, and the merged top 4 of every rank's candidates."""
    assert [r["initialized"] for r in ranks] == [True, True]
    assert [(r["rank"], r["world"]) for r in ranks] == [(0, 2), (1, 2)]
    assert [r["psum"] for r in ranks] == [8.0 * 4 * (1 + 2)] * 2
    cand_all = np.random.default_rng(7).standard_normal((8, 4)).astype(np.float32)
    want = np.sort(cand_all.reshape(-1))[::-1][:4]
    for r in ranks:
        np.testing.assert_array_equal(r["merged"], want)


def test_the_barrier_outwaits_the_collective_timeout(ranks):
    """Rank 0 sleeps past the group's collective timeout before a barrier,
    as it does while it alone prepares and mines the data: rank 1 waits it
    out and both go on."""
    assert worker.LEAD_SLEEP_S > worker.COLLECTIVE_TIMEOUT_S
    assert ranks[1]["barrier_wait_s"] > worker.COLLECTIVE_TIMEOUT_S
    assert ranks[0]["barrier_wait_s"] >= worker.LEAD_SLEEP_S


def _assert_within_step_tolerance(got: dict, want: dict, lrs):
    """tests/test_torch_train.py's hold of the port's three steps on JAX's:
    every element within 1.5 x (lr_2 + lr_3) (Adam normalises rounding
    noise where a gradient is near zero), all but 0.5 % within 1e-4 x lr."""
    n_far, n_all = 0, 0
    for name, w in want.items():
        diff = (got[name] - w).abs()
        assert diff.max().item() <= 1.5 * (lrs[1] + lrs[2]), name
        n_far += int((diff > 1e-4 * lrs[1]).sum())
        n_all += diff.numel()
    assert n_far / n_all < 0.005


def test_two_ranks_train_to_the_single_process_and_jax_parameters(ranks, jtok, init_params,
                                                                   tmp_path):
    """Three steps of batch 8 over 20 samples, dropout 0, in-batch
    negatives: the last batch is half padding and rank 1 holds only padding
    rows. The ranks end bit for bit equal, and within the step tolerance of
    the port's single-process trainer and of the JAX trainer over 8 devices
    (one row each)."""
    got = ranks[0]["p0_losses"]
    assert len(got) == 3 and ranks[1]["p0_losses"] == got  # the global batch's terms
    for name, p in ranks[0]["p0_state"].items():
        assert torch.equal(p, ranks[1]["p0_state"][name]), name
    no_clock = [[{k: v for k, v in h.items() if k != "seconds"} for h in r["p0_history"]]
                for r in ranks]
    assert no_clock[0] == no_clock[1]

    student = _student(jtok, init_params, 0.0)
    trainer = KDTrainer(student, worker.settings())
    _, single_losses = worker.record_steps(trainer)
    single_grads = worker.record_grads(trainer)
    trainer.train(worker.make_samples(20), output_dir=tmp_path / "single", **worker.LENGTHS)
    single = student.module.state_dict()
    # the first update's gradients, summed over the ranks before the clip,
    # are the whole batch's: a mean over the ranks would be half of them
    # (clip and Adam hide a uniform scale from the parameters)
    grads = ranks[0]["p0_grads"]
    assert grads.keys() == single_grads.keys()
    largest = max(float(g.abs().max()) for g in single_grads.values())
    for name, g in grads.items():
        assert torch.equal(g, ranks[1]["p0_grads"][name]), name
        assert float((g - single_grads[name]).abs().max()) <= GRAD_RTOL * largest, name
    norms = [float(torch.linalg.vector_norm(torch.cat([g.reshape(-1) for g in gs.values()])))
             for gs in (grads, single_grads)]
    assert norms[0] == pytest.approx(norms[1], rel=GRAD_RTOL)
    lrs = [trainer._opt.schedule(c) for c in range(3)]
    assert lrs[0] == 0.0 and lrs[1] > 0
    _assert_within_step_tolerance(ranks[0]["p0_state"], single, lrs)

    settings = JSettings.model_validate({"training": worker.TRAINING,
                                         "loss": {"in_batch_negatives": True}})
    jcfg = JConfig.tiny(vocab_size=jtok.vocab_size, hidden_dropout=0.0, attention_dropout=0.0)
    js = JStudent(model_name="tiny-dp", config=jcfg, tokenizer=jtok, seed=1)
    jt = JTrainer(js, settings, mesh=jcreate_mesh(data_parallel=8))
    jt._tx = jt._make_optimizer(3)
    jt._train_step = jt._build_train_step()
    params = jax.tree_util.tree_map(jnp.asarray, init_params)
    opt_state = jt._tx.init(params)
    data = JDataset(worker.make_samples(20, cls=JSample), jtok, num_docs=4, **worker.LENGTHS)
    batches = list(data.batches(8, shuffle=True, seed=settings.training.seed))
    assert len(batches) == 3 and batches[-1]["doc_valid"][4:].sum() == 0
    rng = jax.random.key(settings.training.seed, impl=settings.training.rng_impl)
    jax_losses = []
    for step, batch in enumerate(batches):
        params, opt_state, aux = jt._train_step(
            params, opt_state, jax.device_put(batch, jt._batch_sharding),
            jnp.float32(step / 2), jax.random.fold_in(rng, step))
        jax_losses.append(aux)
    want = bi_encoder_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                      student.config)
    _assert_within_step_tolerance(ranks[0]["p0_state"], want, lrs)
    # each step's loss terms are the global batch's (not a sum or mean of
    # per-rank means): step 1 from equal parameters to f32 summation order,
    # steps 2 and 3 from parameters the step tolerance apart, as
    # tests/test_torch_train.py holds them
    for i, terms in enumerate(got):
        rel = 2e-6 if i == 0 else 2e-4
        for key in ("loss", "margin_mse", "listwise_kd", "contrastive"):
            for other in (float(single_losses[i][key]), float(jax_losses[i][key])):
                assert terms[key] == pytest.approx(other, rel=rel, abs=1e-6), (i, key)


def test_dropout_seeds_differ_by_rank_and_the_ranks_stay_equal(ranks):
    """Two steps at dropout 0.1: finite losses; rank 0 draws the
    single-device seeds, rank 1 others; the parameters stay bit for bit
    equal across the ranks."""
    for r in ranks:
        assert len(r["p1_losses"]) == 2
        assert all(np.isfinite(v) for aux in r["p1_losses"] for v in aux.values())
    assert ranks[0]["p1_losses"] == ranks[1]["p1_losses"]  # the global batch's terms
    single = KDTrainer(StudentModel("tiny", device="cpu",
                                    config=BertConfig.tiny(vocab_size=64)), worker.settings())
    step_seeds = [single._step_seed(s) for s in range(2)]
    assert ranks[0]["p1_seeds"] == [single._tower_seeds(s) for s in step_seeds]
    for a, b in zip(ranks[0]["p1_seeds"], ranks[1]["p1_seeds"]):
        assert len(set(a) | set(b)) == 4
    for name, p in ranks[0]["p1_state"].items():
        assert torch.equal(p, ranks[1]["p1_state"][name]), name


def test_set_mesh_encode_matches_encode(ranks):
    """Each rank encodes its half of every padded chunk and gathers the
    other's: every rank returns the whole array, within the JAX test's 2e-5
    of one device's encode."""
    for r in ranks:
        assert r["encode_mesh"].shape == (len(worker.ENCODE_TEXTS), 64)
        np.testing.assert_allclose(r["encode_mesh"], r["encode"], atol=2e-5)
    np.testing.assert_array_equal(ranks[0]["encode_mesh"], ranks[1]["encode_mesh"])


# ---------------------------------------------------------------------------
# In one process
# ---------------------------------------------------------------------------


def test_initialize_distributed_without_the_variables_returns_false(monkeypatch):
    for name in ("SSKD_COORDINATOR", "SSKD_NUM_PROCESSES", "SSKD_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="process's id"):
        initialize_distributed("127.0.0.1:1", 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_distributed("127.0.0.1:1", 2, 0)


def test_a_data_axis_larger_than_the_world_raises(jtok, init_params):
    student = _student(jtok, init_params, 0.0)
    mesh = create_mesh(data_parallel=2, devices=CPU2)
    for call in (lambda: KDTrainer(student, worker.settings(), mesh=mesh),
                 lambda: student.set_mesh(mesh)):
        with pytest.raises(ConfigError, match="2 entries but this run has 1"):
            call()
    one = create_mesh(data_parallel=1, devices=[torch.device("cpu")])
    student.set_mesh(one)  # a one-process mesh: every row is this rank's
    np.testing.assert_array_equal(student.encode(worker.ENCODE_TEXTS[:3]),
                                  _student(jtok, init_params, 0.0).encode(worker.ENCODE_TEXTS[:3]))


@pytest.mark.parametrize("n", [20, 16])
def test_shards_are_the_whole_batch_rows(jtok, n):
    """A rank's share of each batch is its rows of the whole batch, padding
    rows marked as there."""
    tok = WordPieceTokenizer(jtok.vocab)
    ds = KDDataset(worker.make_samples(n), tok, num_docs=4, **worker.LENGTHS)
    whole = list(ds.batches(8, seed=3))
    shards = [list(ds.batches(8, seed=3, shard=(r, 2))) for r in (0, 1)]
    assert len(shards[0]) == len(shards[1]) == len(whole)
    for i, batch in enumerate(whole):
        for key, arr in batch.items():
            np.testing.assert_array_equal(
                np.concatenate([shards[0][i][key], shards[1][i][key]]), arr)


def test_shares_of_the_loss_sum_to_the_global_loss():
    """combined_kd_loss over two halves of a batch, each dividing by the
    counts of both (what the all-reduce of ``count_reduce`` gives), sums to
    the loss of the whole batch; a half of padding rows adds nothing."""
    rng = np.random.default_rng(5)
    s = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
    t = torch.from_numpy((3 * rng.standard_normal((8, 5))).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(8, 5)) > 0.3).astype(np.float32))
    mask[:, 0] = 1.0
    mask[4:] = 0.0
    whole = tl.combined_kd_loss(s, t, mask, temperature=3.0)
    halves = [slice(0, 4), slice(4, 8)]
    counts = [[tl.margin_mse_terms(s[h], t[h], mask[h])[1],
               tl.listwise_kd_terms(s[h], t[h], mask[h])[1],
               tl.contrastive_terms(s[h], mask[h])[1]] for h in halves]
    total = {k: 0.0 for k in ("loss", "margin_mse", "listwise_kd", "contrastive")}
    for i, h in enumerate(halves):
        def reduce(local, other=counts[1 - i]):
            for c, o in zip(local, other):
                c.add_(o)
        part = tl.combined_kd_loss(s[h], t[h], mask[h], temperature=3.0, count_reduce=reduce)
        for k in total:
            total[k] += float(part[k])
    for k, v in total.items():
        assert v == pytest.approx(float(whole[k]), rel=1e-6, abs=1e-7), k


def test_cli_trains_on_two_cpu_workers(tmp_path):
    """``semantic-kd-torch train --data-parallel 2 --platform cpu`` on the
    smallest input the CLI takes: the command starts the two workers itself;
    one output directory, one result."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "SEMANTIC_KD_TRAINING__NUM_DOCS_PER_QUERY": "2"}
    for name in ("SSKD_COORDINATOR", "SSKD_NUM_PROCESSES", "SSKD_PROCESS_ID"):
        env.pop(name, None)
    out = subprocess.run(
        [sys.executable, "-m", "sskd_tpu_torch.cli.main", "train", "--data-parallel", "2",
         "--platform", "cpu", "--tiny", "--data-dir", "data", "--output-dir", "out",
         "--max-samples", "8", "--stage", "1", "--epochs", "1", "--batch-size", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout)  # one JSON object: rank 0's
    assert result["global_step"] == 3 and result["output_dir"] == "out"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["data", "out"]
    assert (tmp_path / "out" / "best_model" / "weights.pt").exists()
