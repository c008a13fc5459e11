"""ShardedIndex with the ``index`` axis across processes: two gloo ranks of
four CPU entries each form an index axis of 8 (``create_mesh(1, 8)`` over
the group, the layout of scripts/dryrun_multihost.py), each rank holding
only its own four shards, the candidates meeting in one all-gather.

One spawn of the two ranks (this module run as a script) serves every test.
The yardstick is the JAX package's ShardedIndex on the 8 virtual CPU devices
of tests/conftest.py over the same seeded rows (``rows_per_shard`` depends
only on the row count and the shard count, so the shards are the same), and
the port's ShardedIndex on a one-process mesh of 8 CPU entries. 1,000 rows
do not fill the last 128-row shard, so padding shows. Meanwhile two JAX
processes of four devices each try the JAX package's ``save`` on such a
mesh, which the port's must match.

Tolerances: ids equal on both ranks, JAX's and the one-process port's, for
every engine; int8 and int4 scores exact (the one-process port's bit for
bit, JAX's too but the clustered cell scores, within 1e-6 relative as in
tests/test_torch_sharded.py); f32 and bf16 scores within 1e-5.
"""

from __future__ import annotations

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

N, D, K = 1000, 64, 10
N_CLUSTERED, CELL_ROWS, NPROBE = 3000, 256, 3
BATCHES = (1, 5, 64)
LOCAL, WORLD = 4, 2  # CPU entries a rank, ranks
ENGINES = ("exact-float32", "exact-bfloat16", "exact-int8", "exact-int4", "approx-int8",
           "clustered-int8", "refined-int8")
REFINE_M = 40
TEXTS = ["find topic 3", "words 5 topic", "what about topic 17", "document", "topic 250"]
DOCS = [f"document about topic {i} with words {i * 7 % 13}" for i in range(300)]
JOIN_TIMEOUT_S = 180  # every process, start to exit
COLLECTIVE_TIMEOUT_S = 60.0
SCORE_TOL = 1e-5


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def corpus() -> dict:
    """The seeded rows, queries and ids of every engine (the clustered ones:
    12 cells of 256 rows over 8 topics)."""
    rng = np.random.default_rng(21)
    x = _normed(rng, N, D)
    q = x[rng.integers(0, N, 64)] + 0.05 * rng.standard_normal((64, D)).astype(np.float32)
    centers = _normed(rng, 8, D)
    xc = centers[rng.integers(0, 8, N_CLUSTERED)] + 0.2 * rng.standard_normal((N_CLUSTERED, D))
    xc = (xc / np.linalg.norm(xc, axis=1, keepdims=True)).astype(np.float32)
    qc = xc[rng.integers(0, N_CLUSTERED, 64)] + 0.05 * rng.standard_normal((64, D))
    return {"x": x, "q": q.astype(np.float32), "ids": [f"d{i}" for i in range(N)],
            "xc": xc, "qc": qc.astype(np.float32), "idsc": [f"c{i}" for i in range(N_CLUSTERED)]}


def build(cls, mesh, engine: str, data: dict, builders: dict):
    """``engine``'s sharded index of either package (``builders``: its
    single-device approx and clustered indexes)."""
    kind, dtype = engine.split("-")
    if kind in ("approx", "clustered"):
        return cls.from_builder(builders[kind], mesh)
    return cls(mesh, block_rows=128).build_from_arrays(
        data["x"], data["ids"], dtype=dtype, refine_m=REFINE_M if kind == "refined" else 0)


def queries(engine: str, data: dict) -> np.ndarray:
    return data["qc"] if engine.startswith("clustered") else data["q"]


def searches(index, engine: str, data: dict) -> dict:
    """``(scores, positions)`` of every batch size."""
    q = queries(engine, data)
    return {B: tuple(np.asarray(a) for a in index.search(q[:B], k=K)) for B in BATCHES}


def held(index) -> dict:
    """The elements of each array the index holds in this process."""
    out = {"vectors": sum(t.numel() for t in index._vectors)}
    for name in ("_scales", "_refine", "_centroids"):
        if getattr(index, name) is not None:
            out[name[1:]] = sum(t.numel() for t in getattr(index, name))
    return out


# ---------------------------------------------------------------------------
# The ranks (this module run as a script)
# ---------------------------------------------------------------------------


def rank_main(work: Path) -> None:
    """One rank: every engine over ``create_mesh(1, 8)`` of the group, the
    JAX-saved index loaded, the fused searcher, the refused layouts, the
    save, and the rank-per-row layout; writes ``work/rank_R.pt``."""
    import torch.distributed as dist

    from sskd_tpu_torch.exceptions import IndexBuildError
    from sskd_tpu_torch.index.builder import IndexBuilder
    from sskd_tpu_torch.index.sharded import ShardedIndex
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.parallel.distributed import initialize_distributed
    from sskd_tpu_torch.parallel.mesh import create_mesh, set_cpu_devices
    from sskd_tpu_torch.serve.fused import ShardedFusedSearcher

    set_cpu_devices(LOCAL)
    initialize_distributed(device="cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    rank = dist.get_rank()
    data = corpus()
    builders = {kind: IndexBuilder(device="cpu").load(work / kind)
                for kind in ("approx", "clustered")}
    mesh = create_mesh(1, WORLD * LOCAL, device="cpu")
    out = {"rank": rank, "mesh_ranks": mesh.ranks, "engines": {}, "held": {}}
    indexes = {}
    for engine in ENGINES:
        indexes[engine] = idx = build(ShardedIndex, mesh, engine, data, builders)
        out["engines"][engine] = searches(idx, engine, data)
        out["held"][engine] = held(idx)
        out.setdefault("shards", (idx.first, idx.stop, idx.n_shards, idx.over_group))
    pos = np.array([[0, 5, -1], [N_CLUSTERED - 1, 256, 1]], dtype=np.int32)
    out["map_positions"] = indexes["clustered-int8"].map_positions(pos)

    loaded = ShardedIndex(mesh, block_rows=128).load(work / "jax_int8")
    out["loaded"] = searches(loaded, "exact-int8", data)
    out["loaded_held"] = held(loaded)

    student = StudentModel(str(work / "student"), device="cpu")
    out["fused"] = ShardedFusedSearcher(student, indexes["exact-int8"]).search_texts(TEXTS, k=K)

    out["save"] = None
    try:
        indexes["exact-int8"].save(work / f"saved_{rank}")
    except IndexBuildError as e:
        out["save"] = str(e)
    out["save_wrote"] = (work / f"saved_{rank}").exists()

    out["refused"] = {}
    cpu = torch.device("cpu")
    for case, kw in (("unequal runs", dict(data_parallel=1, index_parallel=3,
                                           devices=[cpu] * 3, ranks=[0, 0, 1])),
                     ("rows across ranks", dict(data_parallel=2, index_parallel=2,
                                                devices=[cpu] * 4, ranks=[0, 1, 0, 1])),
                     ("a rank left out", dict(data_parallel=1, index_parallel=LOCAL,
                                              device="cpu"))):
        try:
            create_mesh(**kw)
            out["refused"][case] = None
        except ValueError as e:
            out["refused"][case] = str(e)

    # the data axis over the processes, the index axis inside each
    rows = create_mesh(data_parallel=WORLD, index_parallel=LOCAL, device="cpu")
    per_row = build(ShardedIndex, rows, "exact-int8", data, builders)
    out["per_row"] = {"mesh_ranks": rows.ranks, "over_group": per_row.over_group,
                      "shards": (per_row.first, per_row.stop),
                      "search": searches(per_row, "exact-int8", data)}
    torch.save(out, work / f"rank_{rank}.pt")
    dist.destroy_process_group()


def jax_save_main(work: Path, port: int, pid: int) -> None:
    """One of two JAX processes of four CPU devices each (as
    scripts/dryrun_multihost.py starts them): the JAX package's
    ShardedIndex over ``create_mesh(1, 8)`` of both, then its ``save``;
    writes what the save did to ``work/jax_save_P.json``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", LOCAL)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    from sskd_tpu.index.sharded import ShardedIndex as JSharded
    from sskd_tpu.parallel.mesh import create_mesh as jcreate_mesh
    from sskd_tpu.parallel.mesh import initialize_distributed as jinitialize

    jinitialize(coordinator_address=f"127.0.0.1:{port}", num_processes=WORLD, process_id=pid)
    data = corpus()
    idx = JSharded(jcreate_mesh(1, WORLD * LOCAL)).build_from_arrays(data["x"], data["ids"],
                                                                      dtype="int8")
    try:
        idx.save(work / f"jax_saved_{pid}")
        out = {"raised": None}
    except Exception as e:  # noqa: BLE001 - what JAX raises is the record
        out = {"raised": type(e).__name__, "message": str(e)}
    (work / f"jax_save_{pid}.json").write_text(json.dumps(out))


# ---------------------------------------------------------------------------
# The test process
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv: list[str], env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *argv], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _tiny_student(path: Path) -> None:
    from sskd_tpu_torch.models.bert import BertConfig
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.tokenization import WordPieceTokenizer

    tok = WordPieceTokenizer.build_from_corpus(DOCS + ["query passage what find about"],
                                               vocab_size=512)
    StudentModel("tiny-processes", device="cpu", tokenizer=tok, seed=3,
                 config=BertConfig.tiny(vocab_size=tok.vocab_size)).save(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' records and the JAX save's, beside the JAX yardstick and
    the one-process port, computed while the ranks run."""
    from sskd_tpu.index.builder import IndexBuilder as JBuilder
    from sskd_tpu.index.sharded import ShardedIndex as JSharded
    from sskd_tpu.parallel.mesh import create_mesh as jcreate_mesh
    from sskd_tpu_torch.index.builder import IndexBuilder
    from sskd_tpu_torch.index.sharded import ShardedIndex
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.parallel.mesh import create_mesh
    from sskd_tpu_torch.serve.fused import ShardedFusedSearcher

    work = tmp_path_factory.mktemp("processes")
    data = corpus()
    kw = {"approx": dict(index_type="approx", dtype="int8"),
          "clustered": dict(index_type="clustered", dtype="int8", cluster_rows=CELL_ROWS,
                            nprobe=NPROBE)}
    rows = {"approx": ("x", "ids"), "clustered": ("xc", "idsc")}
    builders = {kind: IndexBuilder(D, device="cpu", **kw[kind]).build_from_arrays(
        data[rows[kind][0]], data[rows[kind][1]]) for kind in kw}
    for kind, b in builders.items():
        b.save(work / kind)
    jmesh = jcreate_mesh(1, WORLD * LOCAL)
    jint8 = JSharded(jmesh, block_rows=128).build_from_arrays(data["x"], data["ids"],
                                                             dtype="int8")
    jint8.save(work / "jax_int8")
    _tiny_student(work / "student")

    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent.parent),
           "OMP_NUM_THREADS": "1", "SSKD_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "SSKD_NUM_PROCESSES": str(WORLD)}
    env.pop("JAX_PLATFORMS", None)  # the JAX processes take the CPU in-process
    jport = _free_port()
    procs = [_spawn(["--rank", str(work)], {**env, "SSKD_PROCESS_ID": str(r)})
             for r in range(WORLD)]
    procs += [_spawn(["--jax-save", str(work), str(jport), str(p)], env) for p in range(WORLD)]
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        jbuilders = {kind: JBuilder(D, **kw[kind]).build_from_arrays(data[rows[kind][0]],
                                                                     data[rows[kind][1]])
                     for kind in kw}
        jax_got = {e: searches(build(JSharded, jmesh, e, data, jbuilders), e, data)
                   for e in ENGINES}
        jax_got["loaded"] = searches(jint8, "exact-int8", data)
        jax_got["per_row"] = searches(
            build(JSharded, jcreate_mesh(WORLD, LOCAL), "exact-int8", data, jbuilders),
            "exact-int8", data)
        one = create_mesh(1, WORLD * LOCAL, devices=[torch.device("cpu")] * (WORLD * LOCAL))
        one_got = {e: searches(build(ShardedIndex, one, e, data, builders), e, data)
                   for e in ENGINES}
        student = StudentModel(str(work / "student"), device="cpu")
        one_got["fused"] = ShardedFusedSearcher(
            student, build(ShardedIndex, one, "exact-int8", data, builders)).search_texts(
            TEXTS, k=K)
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0] * len(procs), "\n".join(logs)
    return {"ranks": [torch.load(work / f"rank_{r}.pt", weights_only=False)
                      for r in range(WORLD)],
            "jax_save": [json.loads((work / f"jax_save_{p}.json").read_text())
                         for p in range(WORLD)],
            "jax": jax_got, "one": one_got, "work": work}


def _assert_same(got, want, engine: str, bitwise: bool):
    """Ids equal; int8 / int4 scores exact (``bitwise``: bit for bit, else
    the clustered cell scores within 1e-6 relative), f32 / bf16 within 1e-5."""
    (gv, gi), (wv, wi) = got, want
    assert gi.dtype == np.int32 and gv.shape == wv.shape
    np.testing.assert_array_equal(gi, wi)
    live = wi >= 0
    if engine.endswith(("int8", "int4")) and not engine.startswith("refined"):
        rtol = 1e-6 if engine.startswith("clustered") and not bitwise else 0.0
        np.testing.assert_allclose(gv[live], wv[live], rtol=rtol, atol=0)
    else:
        np.testing.assert_allclose(gv[live], wv[live], rtol=0, atol=SCORE_TOL)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("engine", ENGINES)
def test_both_ranks_give_the_jax_and_the_one_process_ids(runs, engine, B):
    for rank in runs["ranks"]:
        got = rank["engines"][engine][B]
        _assert_same(got, runs["jax"][engine][B], engine, bitwise=False)
        _assert_same(got, runs["one"][engine][B], engine, bitwise=True)
    if engine.startswith("clustered"):  # original rows, mapped back
        assert set(got[1].ravel()) <= set(range(N_CLUSTERED))


def test_the_mesh_spans_the_group_and_each_rank_holds_its_own_shards(runs):
    """Rank r owns entries 4r..4r+3, holds shards 4r..4r+3 and no more:
    half the rows (and scales, refine rows, cells) of every index."""
    for r, rank in enumerate(runs["ranks"]):
        assert rank["mesh_ranks"] == ((0,) * LOCAL + (1,) * LOCAL,)
        assert rank["shards"] == (LOCAL * r, LOCAL * (r + 1), WORLD * LOCAL, True)
        for engine, held in rank["held"].items():
            cols = D // 2 if engine.endswith("int4") else D
            # rows a shard: 2 of the 12 cells, or 1,000 / 8 rounded up to 128
            rows = 2 * CELL_ROWS if engine.startswith("clustered") else 128
            assert held["vectors"] == LOCAL * rows * cols, engine
            assert held.get("scales", LOCAL * rows) == LOCAL * rows, engine
            if engine.startswith("refined"):
                assert held["refine"] == LOCAL * rows * D
            if engine.startswith("clustered"):
                assert held["centroids"] == LOCAL * 2 * D


def test_a_jax_saved_index_loads_onto_the_two_ranks(runs):
    """Each rank reads its own 4 shards' row ranges of the JAX package's
    sskd-sharded-1 files and answers with the JAX index's ids and scores."""
    for rank in runs["ranks"]:
        assert rank["loaded_held"] == {"vectors": LOCAL * 128 * D, "scales": LOCAL * 128}
        for B in BATCHES:
            _assert_same(rank["loaded"][B], runs["jax"]["loaded"][B], "exact-int8",
                         bitwise=True)


def test_map_positions_gives_the_clustered_original_rows(runs):
    from sskd_tpu_torch.index.builder import IndexBuilder

    b = IndexBuilder(device="cpu").load(runs["work"] / "clustered")
    pos = np.array([[0, 5, -1], [N_CLUSTERED - 1, 256, 1]], dtype=np.int32)
    for rank in runs["ranks"]:
        np.testing.assert_array_equal(rank["map_positions"], b.map_positions(pos))


def test_the_fused_searcher_gives_every_rank_the_one_process_ids(runs):
    want_v, want_i = runs["one"]["fused"]
    for rank in runs["ranks"]:
        got_v, got_i = rank["fused"]
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_v, want_v, rtol=0, atol=SCORE_TOL)


def test_save_across_processes_raises_as_the_jax_package_does(runs):
    """JAX refuses to fetch an array that spans non-addressable devices, on
    every process; the port raises IndexBuildError on every rank and writes
    nothing."""
    for jax_save in runs["jax_save"]:
        assert jax_save["raised"] == "RuntimeError"
        assert "non-addressable" in jax_save["message"]
    for rank in runs["ranks"]:
        assert "more than one process" in rank["save"] and not rank["save_wrote"]


def test_layouts_the_port_cannot_serve_raise(runs):
    for rank in runs["ranks"]:
        msgs = rank["refused"]
        assert "mesh 1x3" in msgs["unequal runs"]
        assert "mesh 2x2" in msgs["rows across ranks"]
        assert "without an entry" in msgs["a rank left out"]


def test_the_data_axis_over_processes_keeps_the_index_inside_each(runs):
    """``create_mesh(data_parallel=2, index_parallel=4)`` over the group: row
    r is rank r's, each rank holds its row's four shards and searches them
    without a collective, with the JAX [2, 4] mesh's ids."""
    for r, rank in enumerate(runs["ranks"]):
        per_row = rank["per_row"]
        assert per_row["mesh_ranks"] == ((0,) * LOCAL, (1,) * LOCAL)
        assert per_row["shards"] == (0, LOCAL) and not per_row["over_group"]
        for B in BATCHES:
            _assert_same(per_row["search"][B], runs["jax"]["per_row"][B], "exact-int8",
                         bitwise=True)


def test_a_group_mesh_needs_the_group():
    from sskd_tpu_torch.parallel.distributed import all_gather_candidates
    from sskd_tpu_torch.parallel.mesh import create_mesh

    cpu = [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="needs the group"):
        create_mesh(1, 2, devices=cpu, ranks=[0, 1])
    with pytest.raises(ValueError, match="pass both"):
        create_mesh(1, 2, ranks=[0, 1])
    with pytest.raises(RuntimeError, match="process group"):
        all_gather_candidates(torch.zeros(1, 2), torch.zeros(1, 2, dtype=torch.int32))


if __name__ == "__main__":
    if sys.argv[1] == "--rank":
        rank_main(Path(sys.argv[2]))
    else:
        jax_save_main(Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
