"""How far one KD train step's gradients move when only the attention's
arithmetic changes: the spread behind the bf16 gradient gate of
``chip_smoke.py``'s train phase.

At full e5-small-v2 width on one GPU, for each of four packed batches of the
train phase's synthetic data, at the seeded init and after ``--trainings``
separate 16-step trainings from it, the step's gradients (``step_grads``)
through five attentions:

- ``K``: the dropattn kernels on their own routes (bf16: tensor cores);
- ``Kfcc``: the same with the forward on its CUDA-core kernel;
- ``P``: the plain pair computing in bf16 (the gate's reference);
- ``Pshift``: the plain pair with 0.5 added to the bias, the same function
  rounded otherwise;
- ``F``: the plain pair computing in f32 inside (the gate's yardstick).

It prints, per batch, each distance relative to the norm of ``P``'s
gradients, and writes them to ``chiprun_out/grad_gate_probe.json``. By
default every run of a batch takes Margin-MSE's max where ``P`` found it, as
the gate does; ``--no-pin`` lets each take its own.

    python3 tools/grad_gate_probe.py [--no-pin] [--trainings 3]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PAIRS = (("K", "P"), ("Kfcc", "P"), ("F", "P"), ("Pshift", "P"), ("K", "F"), ("P", "F"),
         ("Pshift", "F"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-pin", action="store_true", help="each run takes its own argmax")
    ap.add_argument("--trainings", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_gate_probe: needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from sskd_tpu_torch.utils.logging import setup_logging

    setup_logging(level="WARNING")
    cs.phase_build()

    from sskd_tpu_torch.config import Settings
    from sskd_tpu_torch.kd.dataset import KDDataset
    from sskd_tpu_torch.kd.train import KDTrainer
    from sskd_tpu_torch.models import bert
    from sskd_tpu_torch.models.student import StudentModel
    from sskd_tpu_torch.ops import attention as ta

    kernels, fwd_route = bert.dropout_attention, ta.dropattn_fwd_route
    plain = cs.PlainDropoutAttention.apply

    def forward_on_cuda_cores(q, k, v, b, p, s):
        ta.dropattn_fwd_route = lambda dtype, d, L: "cuda_core"
        return kernels(q, k, v, b, p, s)

    attns = {
        "P": lambda q, k, v, b, p, s: plain(q, k, v, b, p, s, torch.bfloat16),
        "K": kernels,
        "Kfcc": forward_on_cuda_cores,
        "Pshift": lambda q, k, v, b, p, s: plain(q, k, v, b + 0.5, p, s, torch.bfloat16),
        "F": lambda q, k, v, b, p, s: plain(q, k, v, b, p, s, torch.float32),
    }

    def grads(trainer, batch, attn, pinned):
        bert.dropout_attention = attn  # step_grads with compute None runs it
        try:
            return cs.step_grads(trainer, batch, None, pinned)
        finally:
            bert.dropout_attention, ta.dropattn_fwd_route = kernels, fwd_route

    def setup():
        settings = Settings.from_dict({"training": {
            "epochs": 1, "batch_size": 32, "learning_rate": 2e-5, "weight_decay": 0.01,
            "warmup_ratio": 0.1, "max_grad_norm": 1.0, "num_docs_per_query": 8,
            "remat": True, "remat_policy": "full", "resume": False, "seed": 0,
        }})
        student = StudentModel("intfloat/e5-small-v2", device="cuda",
                               compute_dtype=torch.bfloat16, seed=0)
        return KDTrainer(student, settings)

    out: dict = {"pinned": not args.no_pin}
    out_path = ROOT / "chiprun_out" / "grad_gate_probe.json"
    out_path.parent.mkdir(exist_ok=True)

    def table(name, trainer, packed):
        rows = []
        for bi, b in enumerate(packed):
            pinned = None if args.no_pin else {}
            g = {n: grads(trainer, b, f, pinned) for n, f in attns.items()}
            norm = g["P"].norm().item()
            r = {"batch": bi, "norm": norm,
                 "moved": None if pinned is None else pinned["moved"]}
            for a, c in PAIRS:
                r[f"{a}-{c}"] = (g[a] - g[c]).norm().item() / norm
            rows.append(r)
            print(name, json.dumps(r), flush=True)
        out[name] = rows
        out_path.write_text(json.dumps(out, indent=1))

    samples = cs.make_kd_samples(cs.TRAIN_QUERIES, 8, 0)
    trainer = setup()
    ds = KDDataset(samples[:32 * 4], trainer.student.tokenizer, num_docs=8, query_len=64,
                   doc_len=192)
    packed = list(ds.batches(32, shuffle=False))
    table("init", trainer, packed)
    for rep in range(args.trainings):
        trainer = setup()
        with tempfile.TemporaryDirectory() as d:
            trainer.train(samples, output_dir=d, query_len=64, doc_len=192)
        table(f"trained{rep}", trainer, packed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
