"""TeacherModel: the cross-encoder wrapper (port of sskd_tpu/models/teacher.py).

API as in the JAX package: ``score(pairs, batch_size) -> list[float]`` raw
relevance logits, ``predict`` (an alias), ``predict_score`` for one pair,
``get_confidence`` (the sigmoid of a logit, stage-2 mining's threshold) and
``save``. A chunk of pairs is framed ``[CLS] q [SEP] d [SEP]`` and padded to
the bucket of its longest pair (the port's ``bucket_length`` ladder), and the
host tokenizes chunk i + 1 while the device runs the forward of chunk i.

Differences from the JAX package:
- ``device`` defaults to ``"cuda"`` and is never guessed: without CUDA the
  constructor raises unless the caller passes ``device="cpu"``;
- a model with no weights on disk gets seeded random weights drawn in the
  Flax layout (:func:`~sskd_tpu_torch.models.weights.random_jax_params`) and
  carried over, bge-reranker-large's width when the name says "reranker";
  ``params`` takes such a Flax-layout tree of numpy arrays, e.g. a JAX
  checkpoint's parameters;
- the checkpoint format is the port's own (``sskd_config.json`` with the
  JAX package's keys, ``weights.pt`` with the CrossEncoder's f32
  state_dict, ``tokenizer/``), or the JAX package's (``params.msgpack`` in
  place of ``weights.pt``, read by the port's own msgpack reader;
  ``weights.pt`` wins when both are there); an HF checkpoint directory
  (``config.json`` with ``model.safetensors`` or ``pytorch_model.bin``) goes through
  :mod:`sskd_tpu_torch.models.convert`. A directory the port cannot read
  raises :class:`~sskd_tpu_torch.exceptions.ModelLoadError` or
  :class:`~sskd_tpu_torch.exceptions.WeightConversionError`;
- each text is tokenized once per chunk (the JAX package tokenizes twice);
- the parameters live in ``module`` (a torch ``CrossEncoder``, f32,
  computing in ``config.compute_dtype``): the trainer updates them in
  place, and ``score`` always runs in eval mode;
- ``shard_tensor_parallel`` replaces ``module`` by its tensor-parallel copy
  (:mod:`sskd_tpu_torch.parallel.tp`, whole heads a shard, so the heads
  must divide by the axis size); ``score``, ``forward_batch`` and rerank
  then run it, ``save`` writes the unsharded weights, and
  :class:`~sskd_tpu_torch.kd.teacher_train.TeacherTrainer` refuses it
  (tensor parallelism is for scoring).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from sskd_tpu_torch.exceptions import WeightConversionError
from sskd_tpu_torch.models.bert import BertConfig, CrossEncoder, release_casts
from sskd_tpu_torch.models.student import ARCH_KEYS, bucket_length
from sskd_tpu_torch.models.weights import (
    checkpoint_state,
    cross_encoder_from_jax_params,
    random_jax_params,
)
from sskd_tpu_torch.parallel.tp import is_tensor_parallel, shard_params_tp, unsharded_state_dict
from sskd_tpu_torch.tokenization import WordPieceTokenizer, get_default_tokenizer
from sskd_tpu_torch.utils.logging import get_logger
from sskd_tpu_torch.utils.platform import resolve_device

logger = get_logger("models.teacher")


class TeacherModel:
    """Cross-encoder teacher (bge-reranker-large class)."""

    def __init__(
        self,
        model_name: str | None = None,
        device: str | torch.device | None = "cuda",
        config: BertConfig | None = None,
        tokenizer: WordPieceTokenizer | None = None,
        params=None,
        max_seq_length: int = 512,
        seed: int = 0,
    ):
        self.model_name = model_name or "BAAI/bge-reranker-large"
        self.device = resolve_device(device)
        self.max_seq_length = max_seq_length

        state = None
        path = Path(model_name) if model_name else None
        if path is not None and path.is_dir():
            if (path / "sskd_config.json").exists():
                state = self._load_own_checkpoint(path)
            elif (path / "config.json").exists():
                state = self._load_hf_checkpoint(path)
        if state is None:
            self.config = config or (
                BertConfig.bge_reranker_large() if "reranker" in self.model_name
                else BertConfig.tiny()
            )
            self.tokenizer = tokenizer or get_default_tokenizer()
            if params is None:
                params = random_jax_params(self.config, seed, cross_encoder=True)
                logger.warning(
                    f"no local weights for {self.model_name!r}; seeded random init "
                    f"({self.config.num_layers}L/{self.config.hidden_size}H, seed {seed})"
                )
            state = cross_encoder_from_jax_params(params, self.config)
        elif params is not None:
            state = cross_encoder_from_jax_params(params, self.config)
        if tokenizer is not None:
            self.tokenizer = tokenizer
        # f32 parameters; each op computes in config.compute_dtype
        self.module = CrossEncoder(self.config)
        try:
            self.module.load_state_dict(state)
        except RuntimeError as e:  # missing, unexpected or misshapen weights (on the CPU)
            raise WeightConversionError(f"weights do not fit {self.config}: {e}") from e
        self.module.to(device=self.device).eval()

    # ------------------------------------------------------------------
    # Loading / saving
    # ------------------------------------------------------------------

    def _load_own_checkpoint(self, path: Path) -> dict:
        with open(path / "sskd_config.json") as f:
            meta = json.load(f)
        self.config = BertConfig(**{k: meta["architecture"][k] for k in ARCH_KEYS})
        self.max_seq_length = meta.get("max_seq_length", 512)
        self.tokenizer = WordPieceTokenizer.from_pretrained_dir(path / "tokenizer")
        state = checkpoint_state(path, self.config, cross_encoder=True)
        logger.info(f"loaded teacher checkpoint from {path}")
        return state

    def _load_hf_checkpoint(self, path: Path) -> dict:
        from sskd_tpu_torch.models.convert import (
            convert_cross_encoder,
            hf_config_to_bert_config,
            load_hf_checkpoint,
        )

        sd, hf_cfg = load_hf_checkpoint(path)
        self.config = hf_config_to_bert_config(hf_cfg)
        self.tokenizer = (WordPieceTokenizer.from_pretrained_dir(path)
                          if (path / "vocab.txt").exists() else get_default_tokenizer())
        logger.info(f"converted HF teacher checkpoint from {path}")
        return cross_encoder_from_jax_params(convert_cross_encoder(sd, self.config), self.config)

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        meta = {
            "model_name": self.model_name,
            "architecture": {k: getattr(self.config, k) for k in ARCH_KEYS},
            "max_seq_length": self.max_seq_length,
        }
        with open(path / "sskd_config.json", "w") as f:
            json.dump(meta, f, indent=2)
        state = (unsharded_state_dict(self.module) if is_tensor_parallel(self.module)
                 else self.module.state_dict())
        state = {k: v.detach().to("cpu", torch.float32) for k, v in state.items()}
        torch.save(state, path / "weights.pt")
        self.tokenizer.save(path / "tokenizer")
        logger.info(f"saved teacher checkpoint to {path}")
        return path

    # ------------------------------------------------------------------
    # Scoring
    # ------------------------------------------------------------------

    def shard_tensor_parallel(self, mesh, axis: str = "index") -> None:
        """Split this teacher's matrix products over the devices of a mesh
        axis (Megatron's layout, :mod:`sskd_tpu_torch.parallel.tp`); the
        inputs and the residual stream live on the axis's first device."""
        self.module = shard_params_tp(self.module, mesh, axis)
        self.device = mesh.devices_along(axis)[0]

    def tokenize_pairs(self, pairs: Sequence[tuple[str, str]]) -> dict:
        """``[CLS] q [SEP] d [SEP]`` arrays [B, L] (int32), L the bucket of
        the longest pair (at most ``max_seq_length``)."""
        # ids cut to max_seq_length lose nothing: frame_pairs cuts each pair
        # to at most max_seq_length - 3 tokens, whatever the longer side held
        a = self.tokenizer.ids_batch([q for q, _ in pairs], self.max_seq_length)
        b = self.tokenizer.ids_batch([d for _, d in pairs], self.max_seq_length)
        longest = 3 + max(len(x) + len(y) for x, y in zip(a, b))
        length = bucket_length(longest, self.max_seq_length, self.device)
        return self.tokenizer.frame_pairs(a, b, length)

    def forward_batch(self, batch: dict) -> torch.Tensor:
        """Logits [B] f32 on the model's device for a tokenized batch, in
        eval mode (no dropout) whatever mode training left the module in."""
        ids, mask, types = (torch.from_numpy(batch[k]).to(self.device, non_blocking=True)
                            for k in ("input_ids", "attention_mask", "token_type_ids"))
        was_training = self.module.training
        self.module.eval()
        try:
            with torch.inference_mode():
                return self.module(ids.long(), mask, types.long())
        finally:
            self.module.train(was_training)

    def score(self, pairs: Sequence[Sequence[str]], batch_size: int = 32) -> list[float]:
        """Raw relevance logits for (query, doc) pairs, lists or tuples."""
        pairs = [tuple(p) for p in pairs]
        out: list[float] = []
        # the device runs chunk i while the host tokenizes chunk i + 1: the
        # copy back of chunk i (which waits for the device) comes after
        pending = None
        for start in range(0, len(pairs), batch_size):
            logits = self.forward_batch(self.tokenize_pairs(pairs[start : start + batch_size]))
            if pending is not None:
                out.extend(pending.cpu().numpy().astype(np.float64).tolist())
            pending = logits
        if pending is not None:
            out.extend(pending.cpu().numpy().astype(np.float64).tolist())
        return out

    def predict(self, pairs: Sequence[Sequence[str]]) -> list[float]:
        """Alias for :meth:`score`."""
        return self.score(pairs)

    def predict_score(self, query: str, doc: str) -> float:
        """One pair's logit."""
        return self.score([(query, doc)])[0]

    def cleanup(self) -> None:
        """Release what the model caches beside its parameters: the casts
        of the weights to the compute type, and the CUDA allocator's unused
        blocks (the JAX package drops its compiled scorers)."""
        release_casts(self.module, self.device)

    @staticmethod
    def get_confidence(score: float) -> float:
        """A raw logit mapped to [0, 1] by the sigmoid (stage-2 mining's
        threshold)."""
        return 1.0 / (1.0 + math.exp(-float(score)))
