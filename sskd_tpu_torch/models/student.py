"""StudentModel: the bi-encoder wrapper (port of sskd_tpu/models/student.py).

API as in the JAX package: ``encode / encode_queries / encode_documents /
tokenize_batch / save``, e5 ``"query: "`` /
``"passage: "`` prefixes, batches and sequences padded to a bucket ladder.

Differences from the JAX package:
- ``device`` defaults to ``"cuda"`` and is never guessed: without CUDA the
  constructor raises unless the caller passes ``device="cpu"``;
- a model with no weights on disk gets seeded random weights drawn in the
  Flax layout and carried over (:mod:`sskd_tpu_torch.models.weights`);
  ``params`` takes such a Flax-layout tree of numpy arrays;
- the checkpoint format is the port's own::

      dir/
        sskd_config.json   — arch + wrapper config (same keys as the JAX package)
        weights.pt         — BiEncoder state_dict, f32
        tokenizer/         — vocab.txt + tokenizer_config.json

  and a JAX package's checkpoint directory (the same files with
  ``params.msgpack`` in place of ``weights.pt``) loads too, through the
  port's own msgpack reader (``weights.pt`` wins when both are there), and
  a Hugging Face checkpoint directory (``config.json`` beside
  ``model.safetensors`` or ``pytorch_model.bin``) through
  ``models/convert.py``, as in the JAX package;

- each text is tokenized once per batch (the JAX package tokenizes twice:
  once to pick the bucket, once to encode);
- the parameters live in ``module`` (a torch ``BiEncoder``, f32, computing
  in ``config.compute_dtype``), not in a ``params`` tree: the trainer
  updates them in place, and ``encode*`` always runs in eval mode;
- ``set_mesh`` (data-parallel encoding) spans the processes of a
  ``torch.distributed`` group, one a data-axis entry: each rank encodes its
  share of every padded chunk and all-gathers the rest, so every rank
  returns the whole array (the JAX package shards one jitted encode over
  the devices of the ``data`` axis).

The bucket ladder keeps the JAX package's values, chosen on a TPU and not
yet measured on the H100: the device ladder starts at 16 rows, the CPU
ladder adds 1, 2, 4 and 8.
"""

from __future__ import annotations

import json
from dataclasses import replace
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from sskd_tpu_torch.models.bert import BertConfig, BiEncoder, release_casts
from sskd_tpu_torch.models.weights import (
    bi_encoder_from_jax_params,
    checkpoint_state,
    random_jax_params,
)
from sskd_tpu_torch.parallel import distributed
from sskd_tpu_torch.tokenization import WordPieceTokenizer, get_default_tokenizer
from sskd_tpu_torch.utils.logging import get_logger
from sskd_tpu_torch.utils.platform import resolve_device

logger = get_logger("models.student")

BUCKETS_DEVICE = (16, 32, 64, 128, 256, 512)
BUCKETS_HOST = (1, 2, 4, 8) + BUCKETS_DEVICE
ARCH_KEYS = (
    "vocab_size",
    "hidden_size",
    "num_layers",
    "num_heads",
    "intermediate_size",
    "max_position_embeddings",
    "type_vocab_size",
    "layer_norm_eps",
    "hidden_dropout",
    "attention_dropout",
    "pad_token_id",
    "position_style",
)


def buckets_for(device: torch.device) -> tuple[int, ...]:
    return BUCKETS_HOST if device.type == "cpu" else BUCKETS_DEVICE


def bucket_length(n: int, max_len: int, device: torch.device) -> int:
    for b in buckets_for(device):
        if n <= b and b <= max_len:
            return b
    return max_len


class StudentModel:
    """Bi-encoder student (e5-small-v2 class)."""

    def __init__(
        self,
        model_name: str | None = None,
        device: str | torch.device | None = "cuda",
        config: BertConfig | None = None,
        tokenizer: WordPieceTokenizer | None = None,
        params=None,
        normalize: bool = True,
        pooling: str = "mean",
        compute_dtype: torch.dtype | None = None,
        max_seq_length: int = 512,
        query_prefix: str = "query: ",
        passage_prefix: str = "passage: ",
        seed: int = 0,
    ):
        self.model_name = model_name or "intfloat/e5-small-v2"
        self.device = resolve_device(device)
        self.normalize = normalize
        self.pooling = pooling
        self.max_seq_length = max_seq_length
        self.query_prefix = query_prefix
        self.passage_prefix = passage_prefix

        state = None
        path = Path(model_name) if model_name else None
        if path is not None and path.is_dir():
            if (path / "weights.pt").exists() or (path / "params.msgpack").exists():
                state = self._load_own_checkpoint(path)
            elif (path / "config.json").exists():
                state = self._load_hf_checkpoint(path)
        if state is None:
            self.config = config or (
                BertConfig.e5_small_v2() if "e5" in self.model_name else BertConfig.tiny()
            )
            self.tokenizer = tokenizer or get_default_tokenizer()
            if params is None:
                params = random_jax_params(self.config, seed)
                logger.warning(
                    f"no local weights for {self.model_name!r}; seeded random init "
                    f"({self.config.num_layers}L/{self.config.hidden_size}H, seed {seed})"
                )
            state = bi_encoder_from_jax_params(params, self.config)
        elif params is not None:
            state = bi_encoder_from_jax_params(params, self.config)
        if tokenizer is not None:
            self.tokenizer = tokenizer
        if compute_dtype is not None:
            self.config = replace(self.config, compute_dtype=compute_dtype)
        # f32 parameters; each op computes in config.compute_dtype
        self.module = BiEncoder(self.config, normalize=self.normalize, pooling=self.pooling)
        self.module.load_state_dict(state)
        self.module.to(device=self.device).eval()
        self._data_shards: int | None = None  # processes a chunk is encoded over (set_mesh)

    # ------------------------------------------------------------------
    # Loading / saving
    # ------------------------------------------------------------------

    def _load_own_checkpoint(self, path: Path) -> dict:
        with open(path / "sskd_config.json") as f:
            meta = json.load(f)
        self.config = BertConfig(**{k: meta["architecture"][k] for k in ARCH_KEYS})
        self.normalize = meta.get("normalize", True)
        self.pooling = meta.get("pooling", "mean")
        self.max_seq_length = meta.get("max_seq_length", 512)
        self.query_prefix = meta.get("query_prefix", self.query_prefix)
        self.passage_prefix = meta.get("passage_prefix", self.passage_prefix)
        self.tokenizer = WordPieceTokenizer.from_pretrained_dir(path / "tokenizer")
        state = checkpoint_state(path, self.config)
        logger.info(f"loaded student checkpoint from {path}")
        return state

    def _load_hf_checkpoint(self, path: Path) -> dict:
        """A Hugging Face checkpoint directory through ``models/convert.py``
        (``convert_bi_encoder``), its ``vocab.txt`` as the tokenizer."""
        from sskd_tpu_torch.models.convert import (
            convert_bi_encoder,
            hf_config_to_bert_config,
            load_hf_checkpoint,
        )

        sd, hf_cfg = load_hf_checkpoint(path)
        self.config = hf_config_to_bert_config(hf_cfg)
        self.tokenizer = (WordPieceTokenizer.from_pretrained_dir(path)
                          if (path / "vocab.txt").exists() else get_default_tokenizer())
        logger.info(f"converted HF checkpoint from {path}")
        return bi_encoder_from_jax_params(convert_bi_encoder(sd, self.config), self.config)

    def save(self, path: str | Path) -> Path:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        meta = {
            "model_name": self.model_name,
            "architecture": {k: getattr(self.config, k) for k in ARCH_KEYS},
            "normalize": self.normalize,
            "pooling": self.pooling,
            "max_seq_length": self.max_seq_length,
            "query_prefix": self.query_prefix,
            "passage_prefix": self.passage_prefix,
            "embedding_dim": self.embedding_dim,
        }
        with open(path / "sskd_config.json", "w") as f:
            json.dump(meta, f, indent=2)
        state = {k: v.detach().to("cpu", torch.float32)
                 for k, v in self.module.state_dict().items()}
        torch.save(state, path / "weights.pt")
        self.tokenizer.save(path / "tokenizer")
        logger.info(f"saved student checkpoint to {path}")
        return path

    # ------------------------------------------------------------------
    # Encoding
    # ------------------------------------------------------------------

    @property
    def embedding_dim(self) -> int:
        return self.config.hidden_size

    def set_mesh(self, mesh, axis: str = "data") -> None:
        """Encode data-parallel over ``axis`` of ``mesh``, whose entries are
        the processes of this run's group (one each; the other axis only
        adds replicas): every batch is padded to a multiple of their count,
        each rank encodes its rows on its entry's device (the student's) and
        all-gathers the others'. Every rank of the group must call
        ``encode*`` together. ``None`` goes back to one device."""
        if mesh is None:
            self._data_shards = None
            return
        _, dp = distributed.data_axis_rank(mesh, self.device, axis)
        self._data_shards = dp

    def tokenize_batch(self, texts: Sequence[str], pad_to: int | None = None) -> dict:
        """Host-side tokenization to fixed [B, L] int32 arrays; L is the
        bucket of the longest text (``pad_to`` overrides it)."""
        # ids cut to the longest frame they can reach lose nothing
        ids = self.tokenizer.ids_batch(texts, max(pad_to or 0, self.max_seq_length))
        longest = 2 + max((len(i) for i in ids), default=1)
        length = pad_to or bucket_length(longest, self.max_seq_length, self.device)
        return self.tokenizer.frame_batch(ids, length)

    def forward_batch(self, batch: dict) -> torch.Tensor:
        """Embeddings [B, H] f32 on the model's device for a tokenized batch;
        always in eval mode (no dropout), whatever mode training left the
        module in."""
        ids = torch.from_numpy(batch["input_ids"]).to(self.device, non_blocking=True)
        mask = torch.from_numpy(batch["attention_mask"]).to(self.device, non_blocking=True)
        was_training = self.module.training
        self.module.eval()
        try:
            with torch.inference_mode():
                return self.module(ids.long(), mask)
        finally:
            self.module.train(was_training)

    def encode(
        self,
        texts: str | Sequence[str],
        normalize: bool | None = None,
        batch_size: int = 256,
        prefix: str = "",
    ) -> np.ndarray:
        """Encode to [n, embedding_dim] f32 numpy; a bare string is wrapped
        into a one-element list."""
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            return np.zeros((0, self.embedding_dim), np.float32)
        if prefix:
            texts = [prefix + t for t in texts]
        out = []
        # the device runs chunk i while the host tokenizes chunk i + 1: the
        # copy back of chunk i (which waits for the device) comes after
        pending: tuple | None = None
        for start in range(0, len(texts), batch_size):
            chunk = list(texts[start : start + batch_size])
            n = len(chunk)
            padded_n = bucket_length(n, batch_size, self.device)
            shards = self._data_shards or 1
            padded_n = -(-padded_n // shards) * shards  # divisible across the ranks
            chunk += [""] * (padded_n - n)
            batch = self.tokenize_batch(chunk)
            if self._data_shards is not None:  # this rank's rows, then every rank's
                lo, hi = (distributed.rank() * padded_n // shards,
                          (distributed.rank() + 1) * padded_n // shards)
                emb = distributed.all_gather_rows(
                    self.forward_batch({k: v[lo:hi] for k, v in batch.items()}))
            else:
                emb = self.forward_batch(batch)
            if pending is not None:
                out.append(pending[0][: pending[1]].cpu().numpy())
            pending = (emb, n)
        out.append(pending[0][: pending[1]].cpu().numpy())
        emb = np.concatenate(out, axis=0)
        if normalize and not self.normalize:
            emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
        return emb

    def encode_queries(self, texts: str | Sequence[str], batch_size: int = 256) -> np.ndarray:
        return self.encode(texts, batch_size=batch_size, prefix=self.query_prefix)

    def encode_documents(self, texts: str | Sequence[str], batch_size: int = 256) -> np.ndarray:
        return self.encode(texts, batch_size=batch_size, prefix=self.passage_prefix)

    def compute_similarity(self, query_embs, doc_embs) -> np.ndarray:
        """The ``[nq, nd]`` dot (cosine, for normalized rows) matrix of two
        embedding arrays, on the host."""
        return np.asarray(query_embs) @ np.asarray(doc_embs).T

    def cleanup(self) -> None:
        """Release what the model caches beside its parameters: the casts
        of the weights to the compute type, and the CUDA allocator's unused
        blocks (the JAX package drops its compiled encodes)."""
        release_casts(self.module, self.device)
