"""``semantic-kd-torch``: the port's command line (port of sskd_tpu/cli/main.py).

Every subcommand and flag of the JAX package's ``semantic-kd``, with its
defaults, JSON output and exit codes::

  semantic-kd-torch demo-data --out data/raw/demo --samples 200
  semantic-kd-torch prepare --data-dir data --dataset demo
  semantic-kd-torch integrity --data-dir data --dataset demo
  semantic-kd-torch train --data-dir data --dataset demo --stage 2 --epochs 3
  semantic-kd-torch train-teacher --out artifacts/teacher --tiny
  semantic-kd-torch index build --model DIR --data chunks.parquet --out artifacts/index
  semantic-kd-torch index validate --dir artifacts/index
  semantic-kd-torch eval --model DIR --data test.jsonl
  semantic-kd-torch eval-beir --model DIR --dataset scifact
  semantic-kd-torch compare --kd-model DIR --vanilla-model DIR --teacher-model DIR --data F
  semantic-kd-torch serve --port 8000 --index artifacts/index
  semantic-kd-torch export --model DIR --out DIR
  semantic-kd-torch config [--production-audit]
  semantic-kd-torch doctor [--index DIR]

(``python -m sskd_tpu_torch.cli.main ...`` is the same.) Each command runs
on the CUDA device unless ``--platform cpu`` or ``SSKD_PLATFORM=cpu`` asks
for the CPU (the JAX CLI's switch), and exits with an error, without
falling back, when CUDA is wanted and absent. ``serve --shards N`` shards
the served index over N devices (``mesh.index_parallel``): every CUDA device
of the machine, or with ``--cpu-devices N`` (which runs the command on the
CPU) a CPU mesh of N entries, the port's counterpart of the JAX flag's
virtual devices; a mesh the devices cannot hold exits 2 before the server
starts. What the port does not have fails the same way, with a message,
never silently: ``--platform`` other than cpu, cuda or gpu. ``serve
--workers N > 1`` forks worker processes on the CPU only; on the card it
warns and serves one process, as the JAX CLI does on a TPU.

Every command first joins the process group that ``SSKD_COORDINATOR``,
``SSKD_NUM_PROCESSES`` and ``SSKD_PROCESS_ID`` describe, when they are set
(``initialize_distributed``, as the JAX CLI does). ``train --data-parallel
N`` (N > 1) trains data-parallel, one process a data-axis entry: inside a
group N must equal its size, else the command exits 2; outside one it
starts N local workers itself, joined on a free port of 127.0.0.1 (gloo
under ``--platform cpu``, NCCL on ``cuda:r`` otherwise; N must not pass the
CUDA device count, checked before any work), so that one command means
what the JAX CLI's does. Rank 0 prints the result; the command exits
non-zero when a worker does, and a worker left waiting on a failed one is
killed after ``WORKER_GRACE_S``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from sskd_tpu_torch.exceptions import ConfigError

_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}
# how long the other workers of `train --data-parallel` may run on once one
# has failed (they would wait for it in their next collective)
WORKER_GRACE_S = 30.0


def _add_platform_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--platform", default=None,
                   help="cpu, or cuda (the default; also 'gpu'); overrides SSKD_PLATFORM")
    p.add_argument("--cpu-devices", type=int, default=None,
                   help="run on the CPU, as a mesh of N CPU entries (the JAX CLI's virtual "
                   "CPU device count)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="semantic-kd-torch",
        description="Semantic search + knowledge distillation, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("demo-data", help="generate the offline synthetic dataset")
    p.add_argument("--out", default="data/raw/demo")
    p.add_argument("--samples", type=int, default=200)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--splits", default="train=0.8,validation=0.2",
                   help="name=fraction list, e.g. train=0.7,validation=0.15,test=0.15")
    p.add_argument("--see-also", type=int, default=0,
                   help="lexical-trap tail words per doc (query-side words of other concepts)")
    p.add_argument("--n-hard", type=int, default=3, help="hard distractors per query")
    _add_platform_arg(p)

    p = sub.add_parser("prepare", help="chunk raw JSONL to parquet")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--dataset", default="demo")
    p.add_argument("--max-tokens", type=int, default=512)
    p.add_argument("--stride", type=int, default=80)
    p.add_argument("--max-samples", type=int, default=None)
    _add_platform_arg(p)

    p = sub.add_parser("integrity", help="verify dataset integrity")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--dataset", default="demo")
    _add_platform_arg(p)

    p = sub.add_parser("train", help="run the end-to-end KD training pipeline")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--dataset", default="demo")
    p.add_argument("--output-dir", default=None)
    p.add_argument("--stage", type=int, default=None, choices=[1, 2, 3])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--tiny", action="store_true", help="tiny architectures (demo/CI)")
    p.add_argument("--student-arch", default="tiny", choices=["tiny", "demo"],
                   help="with --tiny: student size, 'tiny' (2L/64H) or 'demo' (4L/128H)")
    p.add_argument("--save-init", default=None,
                   help="save the untrained student here before training (the vanilla baseline)")
    p.add_argument("--dev-data", default=None,
                   help="held-out raw JSONL: its retrieval nDCG@10 drives early stopping")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="DP mesh size (default: mesh.data_parallel setting): a process per "
                   "entry, started by this command outside a process group")
    _add_platform_arg(p)

    p = sub.add_parser("train-teacher",
                       help="train the cross-encoder teacher on relevance labels")
    p.add_argument("--data-dir", default="data")
    p.add_argument("--dataset", default="demo")
    p.add_argument("--out", required=True, help="teacher checkpoint dir")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--tiny", action="store_true")
    _add_platform_arg(p)

    p = sub.add_parser("index", help="vector index operations")
    index_sub = p.add_subparsers(dest="index_command", required=True)
    pb = index_sub.add_parser("build", help="encode a corpus parquet and build the index")
    pb.add_argument("--model", required=True)
    pb.add_argument("--data", required=True, help="prepared corpus parquet")
    pb.add_argument("--out", required=True)
    pb.add_argument("--batch-size", type=int, default=256)
    pb.add_argument("--max-docs", type=int, default=None)
    pb.add_argument("--dtype", default=None, choices=["float32", "bfloat16", "int8", "int4"],
                    help="default: index.dtype setting")
    pb.add_argument("--method", default=None, choices=["exact", "approx", "clustered"],
                    help="default: index.search_method setting")
    pb.add_argument("--refine-m", type=int, default=None,
                    help="int8/int4: candidates for the bf16 rescore (default: "
                    "index.refine_m; 0 disables)")
    pb.add_argument("--tiny", action="store_true")
    _add_platform_arg(pb)
    pv = index_sub.add_parser("validate", help="recall gate vs brute force")
    pv.add_argument("--dir", required=True)
    pv.add_argument("--queries", type=int, default=None,
                    help="default: index.validation_queries setting")
    pv.add_argument("--k", type=int, default=10)
    pv.add_argument("--min-recall", type=float, default=None,
                    help="default: index.validation_recall_at_10 setting")
    pv.add_argument("--nprobe", type=int, default=None,
                    help="clustered indexes: override the saved nprobe for this validation")
    _add_platform_arg(pv)

    p = sub.add_parser("eval", help="retrieval evaluation of a model over raw JSONL")
    p.add_argument("--model", required=True)
    p.add_argument("--data", required=True, help="raw JSONL (msmarco layout)")
    p.add_argument("--max-samples", type=int, default=200)
    p.add_argument("--out", default=None, help="write metrics JSON here")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--teacher", action="store_true",
                   help="the model is a cross-encoder teacher checkpoint (ranks by pair scoring)")
    _add_platform_arg(p)

    p = sub.add_parser("eval-beir", help="doc-level retrieval eval over a prepared BEIR "
                       "corpus (chunk top-k + MaxSim doc aggregation)")
    p.add_argument("--model", required=True)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--dataset", required=True, help="e.g. fiqa / scifact / trec-covid")
    p.add_argument("--max-queries", type=int, default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--tiny", action="store_true")
    _add_platform_arg(p)

    p = sub.add_parser("compare", help="3-way compare + acceptance gate")
    p.add_argument("--kd-model", required=True)
    p.add_argument("--vanilla-model", required=True)
    p.add_argument("--teacher-model", default=None,
                   help="teacher checkpoint: adds the teacher row and enforces the "
                   ">=95%% of teacher acceptance gate")
    p.add_argument("--data", required=True)
    p.add_argument("--max-samples", type=int, default=200)
    p.add_argument("--out", default=None)
    p.add_argument("--gate-ratio", type=float, default=0.95)
    p.add_argument("--tiny", action="store_true")
    _add_platform_arg(p)

    p = sub.add_parser("serve", help="start the search service")
    p.add_argument("--host", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--model", default=None, help="student model path")
    p.add_argument("--index", default=None, help="index dir to preload")
    p.add_argument("--device", default=None)
    p.add_argument("--shards", type=int, default=None,
                   help="shard the index over N devices (mesh.index_parallel)")
    p.add_argument("--hybrid-bm25", default=None, metavar="DIR",
                   help="enable hybrid BM25+semantic fusion with this BM25 index dir")
    p.add_argument("--workers", type=int, default=None,
                   help="CPU-serving worker processes sharing the port via SO_REUSEPORT "
                   "(default service.workers; on the card one process serves, with a warning)")
    _add_platform_arg(p)

    p = sub.add_parser("export", help="quantized model export")
    p.add_argument("--model", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--skip-validate", action="store_true")
    _add_platform_arg(p)

    p = sub.add_parser("config", help="print the resolved settings tree")
    p.add_argument("--production-audit", action="store_true")
    _add_platform_arg(p)

    p = sub.add_parser("doctor", help="environment diagnostics: device, native tokenizer, "
                       "dependencies, kernel cache, index dir health")
    p.add_argument("--index", default=None, help="index dir to inspect")
    _add_platform_arg(p)

    return parser


def _device(args) -> str:
    """The device the command runs on: ``--platform``, else ``SSKD_PLATFORM``,
    else CUDA."""
    cpu_devices = getattr(args, "cpu_devices", None)
    if cpu_devices is not None:
        if cpu_devices < 1:
            raise ConfigError(f"--cpu-devices {cpu_devices}: a CPU mesh needs an entry")
        if getattr(args, "platform", None) not in (None, "cpu"):
            raise ConfigError(f"--cpu-devices runs on the CPU, not --platform {args.platform}")
        from sskd_tpu_torch.parallel.mesh import set_cpu_devices

        set_cpu_devices(cpu_devices)
        return "cpu"
    platform = getattr(args, "platform", None) or os.environ.get("SSKD_PLATFORM") or "cuda"
    if platform not in _PLATFORMS:
        raise ConfigError(f"--platform {platform!r}: the port runs on {sorted(_PLATFORMS)}")
    return _PLATFORMS[platform]


def _student(path_or_name: str, tiny: bool, device: str):
    from sskd_tpu_torch.models.student import StudentModel

    if tiny and not Path(path_or_name).is_dir():
        from sskd_tpu_torch.models.bert import BertConfig

        return StudentModel(path_or_name, device=device, config=BertConfig.tiny())
    return StudentModel(path_or_name, device=device)


def _write_json(path: str | None, obj) -> None:
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f, indent=2)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    args.argv = argv

    import torch.distributed as dist

    from sskd_tpu_torch.parallel import distributed
    from sskd_tpu_torch.utils.logging import get_logger, setup_logging

    setup_logging()
    joined = False  # whether this call made the process group (and ends it)
    try:
        device = _device(args)
        if args.command != "doctor":  # the doctor reports a missing device
            from sskd_tpu_torch.utils.platform import resolve_device

            try:
                resolve_device(device)
            except RuntimeError as e:  # CUDA wanted and absent
                raise ConfigError(str(e)) from e
        # a multi-process run: no-op unless the SSKD_* variables are set
        try:
            joined = not dist.is_initialized() and distributed.initialize_distributed(
                device=device)
        except (ValueError, RuntimeError) as e:
            raise ConfigError(f"process group: {e}") from e
        from sskd_tpu_torch.config import get_settings

        return _run(args, get_settings(), device)
    except ConfigError as e:
        get_logger("cli").error(f"{args.command}: {e}")
        print(f"semantic-kd-torch {args.command}: error: {e}", file=sys.stderr)
        return 2
    finally:
        if joined:
            dist.destroy_process_group()


def _spawn_data_parallel(argv: list[str], n: int, device: str) -> int:
    """``train --data-parallel n`` outside a process group: the same command
    in ``n`` local processes, ranks of a group on a free port of 127.0.0.1.
    Returns 0 when every worker does, else the first failure's code; a
    worker still running ``WORKER_GRACE_S`` after another failed is killed."""
    import socket

    if device == "cuda":
        import torch

        if torch.cuda.device_count() < n:
            raise ConfigError(f"--data-parallel {n} runs a process on each of {n} CUDA devices "
                              f"(NCCL takes one a rank); this machine has "
                              f"{torch.cuda.device_count()}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(Path(__file__).resolve().parents[2])
    # the workers share the host's cores: n processes of a thread per core
    # each spin against each other (a tiny CPU run went from 0.5 s to 66 s)
    threads = os.environ.get("OMP_NUM_THREADS") or str(max(1, (os.cpu_count() or 1) // n))
    env = {**os.environ, "SSKD_COORDINATOR": f"127.0.0.1:{port}",
           "SSKD_NUM_PROCESSES": str(n), "OMP_NUM_THREADS": threads,
           "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
    cmd = [sys.executable, "-m", "sskd_tpu_torch.cli.main", *argv]
    procs = [subprocess.Popen(cmd, env={**env, "SSKD_PROCESS_ID": str(r)}) for r in range(n)]
    kill_at = None
    try:
        while any(p.poll() is None for p in procs):
            if kill_at is None and any(p.poll() not in (None, 0) for p in procs):
                kill_at = time.monotonic() + WORKER_GRACE_S
            if kill_at is not None and time.monotonic() > kill_at:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        print(f"semantic-kd-torch train: error: data-parallel workers failed "
              f"(rank, exit code): {failed}", file=sys.stderr)
        return failed[0][1] if failed[0][1] > 0 else 1
    return 0


def _run(args, settings, device: str) -> int:
    if args.command == "demo-data":
        from sskd_tpu_torch.data.demo import generate_demo_dataset

        split_spec = [part.split("=") for part in args.splits.split(",")]
        manifest = generate_demo_dataset(
            args.out,
            num_samples=args.samples,
            seed=args.seed,
            splits=tuple(name for name, _ in split_spec),
            split_fractions=tuple(float(f) for _, f in split_spec),
            see_also=args.see_also,
            n_hard=args.n_hard,
        )
        print(json.dumps(manifest, indent=2))
        return 0

    if args.command == "prepare":
        from sskd_tpu_torch.data.prepare import prepare_dataset

        manifest = prepare_dataset(args.data_dir, dataset=args.dataset, max_tokens=args.max_tokens,
                                   stride=args.stride, max_samples=args.max_samples)
        print(json.dumps(manifest, indent=2))
        return 0

    if args.command == "integrity":
        from sskd_tpu_torch.data.integrity import check_dataset_integrity

        report = check_dataset_integrity(args.data_dir, args.dataset)
        print(json.dumps(report, indent=2))
        return 0 if report["ok"] else 1

    if args.command == "train":
        from sskd_tpu_torch.cli.pipeline import run_train_pipeline

        if args.batch_size:
            settings = settings.from_dict({"training": {"batch_size": args.batch_size}},
                                          base=settings)
        student_config = teacher_config = None
        if args.tiny:
            from sskd_tpu_torch.models.bert import BertConfig

            student_config = (BertConfig.demo_teacher() if args.student_arch == "demo"
                              else BertConfig.tiny())
            teacher_config = BertConfig.tiny()
        import torch.distributed as dist

        from sskd_tpu_torch.parallel import distributed

        if args.data_parallel is None:
            dp = settings.mesh.data_parallel
            args.data_parallel = dp if dp > 0 else 1
        in_group = dist.is_initialized()
        if in_group and args.data_parallel != distributed.world_size():
            raise ConfigError(f"--data-parallel {args.data_parallel} inside a process group of "
                              f"{distributed.world_size()}: it must equal the group's size")
        if args.data_parallel > 1 and not in_group:
            return _spawn_data_parallel(args.argv, args.data_parallel, device)
        mesh = distributed.process_mesh(device) if args.data_parallel > 1 else None
        result = run_train_pipeline(
            settings,
            data_dir=args.data_dir,
            output_dir=args.output_dir,
            dataset=args.dataset,
            max_samples=args.max_samples,
            stage=args.stage,
            epochs=args.epochs,
            student_config=student_config,
            teacher_config=teacher_config,
            save_init_to=args.save_init,
            dev_data=args.dev_data,
            mesh=mesh,
            device=device,
        )
        if distributed.rank() == 0:
            print(json.dumps({k: v for k, v in result.items() if k != "history"}, indent=2))
        return 0

    if args.command == "train-teacher":
        from sskd_tpu_torch.data.registry import get_raw_path
        from sskd_tpu_torch.kd.teacher_train import TeacherTrainer, triples_from_raw
        from sskd_tpu_torch.models.teacher import TeacherModel

        triples = triples_from_raw(get_raw_path(args.data_dir, args.dataset, "train"),
                                   max_samples=args.max_samples)
        teacher_config, tokenizer = None, None
        if args.tiny:
            from sskd_tpu_torch.models.bert import BertConfig
            from sskd_tpu_torch.tokenization import WordPieceTokenizer

            # a vocabulary fitted to the corpus, as the JAX CLI fits one
            texts = sorted({q for q, _, _ in triples} | {d for _, d, _ in triples})
            tokenizer = WordPieceTokenizer.build_from_corpus(texts, vocab_size=2048)
            teacher_config = BertConfig.tiny(vocab_size=tokenizer.vocab_size)
        teacher = TeacherModel(settings.teacher.model_name, device=device, config=teacher_config,
                               tokenizer=tokenizer, max_seq_length=settings.teacher.max_seq_length)
        result = TeacherTrainer(teacher, learning_rate=args.lr).train(
            triples, steps=args.steps, batch_size=args.batch_size, max_len=args.max_len)
        teacher.save(args.out)
        print(json.dumps({
            "out": args.out,
            "steps": result["steps"],
            "final_loss": result["final_loss"],
            "heldout_pair_accuracy": result["heldout_pair_accuracy"],
            "num_triples": len(triples),
        }, indent=2))
        return 0

    if args.command == "index":
        from sskd_tpu_torch.index.builder import IndexBuilder

        if args.index_command == "build":
            student = _student(args.model, args.tiny, device)
            s = settings.index
            builder = IndexBuilder(
                embedding_dim=student.embedding_dim,
                dtype=args.dtype or s.dtype,
                index_type=args.method or s.search_method,
                metric=s.metric,
                block_rows=s.block_rows,
                recall_target=s.recall_target,
                cluster_rows=s.cluster_rows,
                nprobe=s.nprobe,
                refine_m=args.refine_m if args.refine_m is not None else s.refine_m,
                refine_storage=s.refine_storage,
                device=device,
            )
            builder.build_from_parquet(student, args.data, batch_size=args.batch_size,
                                       max_docs=args.max_docs)
            builder.save(args.out)
            print(json.dumps({"ntotal": builder.ntotal, "out": args.out}))
            return 0
        builder = IndexBuilder(device=device).load(args.dir)
        if args.nprobe is not None:
            builder.nprobe = args.nprobe
        n_queries = args.queries or settings.index.validation_queries
        min_recall = (args.min_recall if args.min_recall is not None
                      else settings.index.validation_recall_at_10)
        report = builder.validate(n_queries=n_queries, k=args.k)
        report["passed"] = report[f"recall@{args.k}"] >= min_recall
        print(json.dumps(report, indent=2))
        return 0 if report["passed"] else 1

    if args.command in ("eval", "compare"):
        from sskd_tpu_torch.cli.pipeline import load_eval_inputs
        from sskd_tpu_torch.kd.eval import KDEvaluator
        from sskd_tpu_torch.models.teacher import TeacherModel

        q_map, corpus, qrels = load_eval_inputs(args.data, args.max_samples)
        ev = KDEvaluator(device=device)
        if args.command == "eval":
            if args.teacher:
                metrics = ev.evaluate_retrieval_teacher(TeacherModel(args.model, device=device),
                                                        q_map, corpus, qrels)
            else:
                metrics = ev.evaluate_retrieval(_student(args.model, args.tiny, device),
                                                q_map, corpus, qrels)
            print(json.dumps(metrics, indent=2))
            _write_json(args.out, metrics)
            return 0
        results = {
            "kd_student": ev.evaluate_retrieval(_student(args.kd_model, args.tiny, device),
                                                q_map, corpus, qrels),
            "vanilla": ev.evaluate_retrieval(_student(args.vanilla_model, args.tiny, device),
                                             q_map, corpus, qrels),
        }
        gate = None
        if args.teacher_model:
            results["teacher"] = ev.evaluate_retrieval_teacher(
                TeacherModel(args.teacher_model, device=device), q_map, corpus, qrels)
            teacher_ndcg = results["teacher"].get("ndcg@10", 0.0)
            gate = {
                "teacher_ndcg@10": teacher_ndcg,
                "threshold": args.gate_ratio * teacher_ndcg,
                "kd_passes": bool(results["kd_student"].get("ndcg@10", 0.0)
                                  >= args.gate_ratio * teacher_ndcg),
            }
        report = KDEvaluator.generate_report(results, title="Model comparison")
        if gate is not None:
            status = "PASSED" if gate["kd_passes"] else "FAILED"
            report += (f"\nAcceptance gate (KD >= {args.gate_ratio:.0%} of teacher "
                       f"nDCG@10 = {gate['threshold']:.4f}): **{status}**\n")
        print(report)
        if args.out:
            with open(args.out, "w") as f:
                f.write(report)
        return 1 if gate is not None and not gate["kd_passes"] else 0

    if args.command == "eval-beir":
        from sskd_tpu_torch.data.prepare import load_beir_eval
        from sskd_tpu_torch.kd.eval import KDEvaluator

        queries, chunks, qrels = load_beir_eval(args.data_dir, args.dataset,
                                                max_queries=args.max_queries)
        metrics = KDEvaluator(device=device).evaluate_retrieval_chunked(
            _student(args.model, args.tiny, device), queries, chunks["text"],
            chunks["doc_id"], qrels)
        print(json.dumps(metrics, indent=2))
        _write_json(args.out, metrics)
        return 0

    if args.command == "serve":
        return _serve(args, settings, device)

    if args.command == "export":
        from sskd_tpu_torch.models.export import export_student_model

        report = export_student_model(_student(args.model, False, device), args.out,
                                      validate=not args.skip_validate)
        print(json.dumps(report, indent=2))
        return 0

    if args.command == "config":
        print(json.dumps(settings.to_dict(), indent=2))
        if args.production_audit:
            problems = settings.validate_for_production()
            print(json.dumps({"production_problems": problems}, indent=2))
            return 0 if not problems else 1
        return 0

    if args.command == "doctor":
        from sskd_tpu_torch.utils.doctor import run_doctor

        report = run_doctor(index_dir=args.index, settings=settings, device=device)
        print(json.dumps(report, indent=2))
        return 0 if report["ok"] else 1

    return 2


def _serve(args, settings, device: str) -> int:
    import asyncio
    import signal

    from sskd_tpu_torch.serve.app import create_app
    from sskd_tpu_torch.serve.http import App, Response, Server
    from sskd_tpu_torch.serve.supervisor import is_worker, reexec_argv, supervise
    from sskd_tpu_torch.utils.logging import get_logger, setup_logging

    if settings.service.log_level != "info":
        setup_logging(level=settings.service.log_level, force=True)
    elif settings.debug:
        setup_logging(level="debug", force=True)
    if args.shards:
        settings = settings.from_dict({"mesh": {"index_parallel": args.shards}}, base=settings)
    if settings.mesh.index_parallel > 1:
        # the mesh is made when an index is loaded: refuse one the devices
        # cannot hold before the server starts
        from sskd_tpu_torch.parallel.mesh import local_devices, mesh_shape_for

        try:
            mesh_shape_for(len(local_devices(args.device or device)), 1,
                           settings.mesh.index_parallel)
        except ValueError as e:
            raise ConfigError(f"mesh.index_parallel={settings.mesh.index_parallel}: {e}") from e

    n_workers = args.workers if args.workers is not None else settings.service.workers
    if n_workers > 1 and not is_worker():
        if device != "cpu":
            # one process owns the card: forks would fight over it
            get_logger("cli").warning(
                f"service.workers={n_workers} ignored on the card; serving single-process"
            )
        else:
            return supervise(reexec_argv(), n_workers)

    if args.hybrid_bm25:
        settings = settings.from_dict(
            {"search": {"hybrid": {"enabled": True, "bm25_index_path": args.hybrid_bm25}}},
            base=settings)
    app = create_app(settings=settings, student_model_path=args.model,
                     device=args.device or device, preload_index_dir=args.index)
    server = Server(
        app,
        host=args.host or settings.service.host,
        port=args.port or settings.service.port,
        read_timeout=settings.service.read_timeout_s,
        idle_timeout=settings.service.idle_timeout_s,
        max_connections=settings.service.max_connections,
        reuse_port=is_worker(),
    )
    metrics_port = settings.monitoring.prometheus_port
    if not (metrics_port and settings.monitoring.prometheus_enabled):
        server.run()
        return 0
    # a second listener serving only the metrics; one drain handler stops both
    mapp = App()

    @mapp.get(settings.monitoring.prometheus_path)
    async def _metrics(request):
        return Response(app.state.metrics.render(),
                        media_type="text/plain; version=0.0.4; charset=utf-8")

    mserver = Server(mapp, host="0.0.0.0", port=metrics_port, handle_signals=False)
    server.handle_signals = False

    async def _run_both():
        loop = asyncio.get_running_loop()

        def _drain():
            for s in (server, mserver):
                if not s._closing:
                    asyncio.ensure_future(s.shutdown())

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, _drain)
            except (NotImplementedError, RuntimeError):
                pass
        await asyncio.gather(server.serve(), mserver.serve())

    asyncio.run(_run_both())
    return 0


if __name__ == "__main__":
    sys.exit(main())
