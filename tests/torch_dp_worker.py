"""One rank of the two-process gloo run of tests/test_torch_data_parallel.py.

    SSKD_COORDINATOR=127.0.0.1:PORT SSKD_NUM_PROCESSES=2 SSKD_PROCESS_ID=R \
        python tests/torch_dp_worker.py WORK_DIR

Reads the two initial students the test saved under WORK_DIR (``init_p0``:
dropout 0, ``init_p1``: dropout 0.1, one set of weights) and writes what
this rank saw to ``WORK_DIR/rank_R.pt``:

- ``initialize_distributed``'s return, rank and world size, and the two
  collectives of scripts/dryrun_multihost.py (a sum over ranks, an
  all-gather of per-rank top-k candidates and their merge);
- how long rank 1 waited at the barrier while rank 0 slept past the
  group's collective timeout (``COLLECTIVE_TIMEOUT_S``), as it would
  while rank 0 alone mines data;
- ``KDTrainer.train`` over a ``[2, 1]`` CPU mesh, one epoch of 20 samples in
  batches of 8 at dropout 0 with in-batch negatives (3 steps, the last
  batch half padding, all of it on rank 1), then two steps at dropout 0.1:
  the parameters after each run, its history, each step's loss terms, the
  dropout seeds each rank drew and the first update's gradients after the
  sum over the ranks;
- ``StudentModel.encode`` with ``set_mesh`` and without it.

Imports torch and the port only. Exits non-zero on any failure.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

WORDS = "alpha beta gamma delta epsilon zeta eta theta iota kappa".split()
TRAINING = {"epochs": 1, "batch_size": 8, "learning_rate": 1e-3, "num_docs_per_query": 4,
            "remat": False, "resume": False}
LENGTHS = {"query_len": 12, "doc_len": 12}
ENCODE_TEXTS = [f"{w} {v} passage about {w}" for w in WORDS for v in WORDS[:2]][:13]
COLLECTIVE_TIMEOUT_S = 10.0  # the group's; rank 0 sleeps past it before a barrier
LEAD_SLEEP_S = COLLECTIVE_TIMEOUT_S + 2.0


def make_samples(n, n_docs=4, seed=0, cls=None):
    """Seeded KD samples (the samples of tests/test_torch_train.py)."""
    if cls is None:
        from sskd_tpu_torch.kd.dataset import KDSample as cls
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


def settings(in_batch_negatives: bool = True):
    from sskd_tpu_torch.config import Settings

    s = Settings.from_dict({"training": TRAINING})
    s.loss.in_batch_negatives = in_batch_negatives
    return s


def record_steps(trainer) -> tuple[list, list]:
    """The dropout seeds and the loss terms of each of the trainer's steps,
    appended to the lists returned as they are drawn and computed."""
    seeds, losses = [], []
    tower_seeds, train_step = trainer._tower_seeds, trainer._train_step
    trainer._tower_seeds = lambda s: seeds.append(tower_seeds(s)) or seeds[-1]
    trainer._train_step = lambda *a: losses.append(train_step(*a)) or losses[-1]
    return seeds, losses


def record_grads(trainer) -> dict:
    """The first update's gradients by parameter name, before the clip (in
    a data-parallel run, after the sum over the ranks), filled in as the
    trainer takes that update (``grad_accum_steps`` 1)."""
    got = {}
    make = trainer._make_optimizer

    def make_recording(total_steps):
        opt = make(total_steps)
        names = [n for n, p in trainer.student.module.named_parameters() if p.requires_grad]

        def keep():
            if not got:
                got.update((n, p.grad.detach().clone()) for n, p in zip(names, opt.params))

        step, reduce = opt.step, opt.grad_reduce

        def keeping_step():
            keep()
            step()

        def keeping_reduce(flat):
            reduce(flat)
            keep()

        if reduce is None:
            opt.step = keeping_step
        else:
            opt.grad_reduce = keeping_reduce
        return opt

    trainer._make_optimizer = make_recording
    return got


def main(work: Path) -> None:
    import torch.distributed as dist

    from sskd_tpu_torch.kd.train import KDTrainer
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.parallel.distributed import (
        all_gather_rows,
        all_reduce_sum_,
        barrier,
        initialize_distributed,
    )
    from sskd_tpu_torch.parallel.mesh import create_mesh

    out = {"initialized": initialize_distributed(device="cpu", timeout_s=COLLECTIVE_TIMEOUT_S)}
    rank, world = dist.get_rank(), dist.get_world_size()
    out.update(rank=rank, world=world)

    # scripts/dryrun_multihost.py's collectives, four rows a rank
    total = torch.full((4, 8), float(rank + 1)).sum()
    all_reduce_sum_([total])
    out["psum"] = float(total)
    cand_all = np.random.default_rng(7).standard_normal((4 * world, 4)).astype(np.float32)
    gathered = all_gather_rows(torch.from_numpy(cand_all[4 * rank:4 * (rank + 1)]))
    out["merged"] = torch.topk(gathered.reshape(-1), 4).values.numpy()

    t0 = time.monotonic()
    if rank == 0:
        time.sleep(LEAD_SLEEP_S)
    barrier()
    out["barrier_wait_s"] = time.monotonic() - t0

    mesh = create_mesh(data_parallel=world, devices=[torch.device("cpu")] * world)
    for tag, samples in (("p0", make_samples(20)), ("p1", make_samples(16, seed=1))):
        student = StudentModel(str(work / f"init_{tag}"), device="cpu")
        trainer = KDTrainer(student, settings(), mesh=mesh)
        seeds, losses = record_steps(trainer)
        grads = record_grads(trainer)
        result = trainer.train(samples, output_dir=work / f"run_{tag}", **LENGTHS)
        out[f"{tag}_state"] = {k: v.clone() for k, v in student.module.state_dict().items()}
        out[f"{tag}_history"] = result["history"]
        out[f"{tag}_seeds"] = seeds
        out[f"{tag}_losses"] = [{k: float(v) for k, v in aux.items()} for aux in losses]
        out[f"{tag}_grads"] = grads

    student.set_mesh(mesh)
    out["encode_mesh"] = student.encode(ENCODE_TEXTS)
    student.set_mesh(None)
    out["encode"] = student.encode(ENCODE_TEXTS)
    torch.save(out, work / f"rank_{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]))
