"""Hugging Face checkpoint -> Flax-layout parameter tree (port of
sskd_tpu/models/convert.py).

The converter maps an HF ``state_dict`` onto the same Flax-layout tree of
numpy arrays that the JAX package builds (``{"params": {"encoder": ...,
"pooler": ..., "classifier": ...}}``, ``Dense`` kernels ``[in, out]``), which
:mod:`sskd_tpu_torch.models.weights` then carries into the port's modules.
Supported source layouts, as in the JAX package:

- BERT encoders (e5-small-v2 family): ``bert.`` / bare ``encoder.layer`` keys;
- XLM-RoBERTa sequence classifiers (bge-reranker-large family): ``roberta.``
  keys with a ``classifier.dense`` / ``classifier.out_proj`` head, or a
  BERT-style ``pooler.dense`` / ``classifier`` head.

Checkpoint files: ``pytorch_model.bin`` through ``torch.load(weights_only=
True)``, and ``model.safetensors`` through :func:`read_safetensors`, a reader
of the port's own (the machine with the GPU has no ``safetensors`` package):
an 8-byte little-endian header length, a JSON header, then the raw
little-endian buffers. bf16 tensors come back as their ``uint16`` bits, which
the converter widens to f32 (exactly: a bf16 value is the top half of an f32
one).

JAX checkpoints (``params.msgpack``, written by ``flax.serialization.to_bytes``
in the JAX package) go through :func:`read_flax_msgpack`, a decoder of that
msgpack layout in the same manner (the machine with the GPU has no
``msgpack`` and no ``flax``).
"""

from __future__ import annotations

import json
import pickle
import struct
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from sskd_tpu_torch.exceptions import ModelLoadError, WeightConversionError
from sskd_tpu_torch.models.bert import BertConfig

# safetensors dtype names -> numpy little-endian types (BF16 as its bits)
_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
    "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?",
}


def _t(x) -> np.ndarray:
    """torch tensor or numpy array -> numpy, bf16 widened to f32 (from a
    torch tensor, or its uint16 bits from :func:`read_safetensors`: no
    weight is stored as uint16 otherwise)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return (x.astype(np.uint32) << 16).view(np.float32) if x.dtype == np.uint16 else x


def _strip_prefix(sd: Mapping[str, object]) -> dict[str, np.ndarray]:
    """Normalize key prefixes: drop a leading 'bert.', 'roberta.' or 'model.'."""
    out = {}
    for key, value in sd.items():
        for prefix in ("bert.", "roberta.", "model."):
            if key.startswith(prefix):
                key = key[len(prefix) :]
                break
        out[key] = _t(value)
    return out


def hf_config_to_bert_config(hf_cfg: dict, compute_dtype: torch.dtype | None = None) -> BertConfig:
    """Map an HF ``config.json`` dict onto :class:`BertConfig`."""
    model_type = hf_cfg.get("model_type", "bert")
    return BertConfig(
        vocab_size=hf_cfg["vocab_size"],
        hidden_size=hf_cfg["hidden_size"],
        num_layers=hf_cfg["num_hidden_layers"],
        num_heads=hf_cfg["num_attention_heads"],
        intermediate_size=hf_cfg["intermediate_size"],
        max_position_embeddings=hf_cfg["max_position_embeddings"],
        type_vocab_size=hf_cfg.get("type_vocab_size", 2),
        layer_norm_eps=hf_cfg.get("layer_norm_eps", 1e-12),
        pad_token_id=hf_cfg.get("pad_token_id", 0),
        position_style="roberta" if "roberta" in model_type else "bert",
        compute_dtype=compute_dtype or torch.float32,
    )


def convert_encoder_params(state_dict: Mapping[str, object], config: BertConfig) -> dict:
    """HF encoder state_dict -> the Flax ``encoder`` subtree (numpy)."""
    sd = _strip_prefix(state_dict)

    def req(key: str) -> np.ndarray:
        if key not in sd:
            raise WeightConversionError(f"missing weight {key!r}")
        return sd[key]

    def dense(prefix: str) -> dict:
        # torch [out, in] -> flax [in, out]
        return {"kernel": req(f"{prefix}.weight").T, "bias": req(f"{prefix}.bias")}

    def norm(prefix: str) -> dict:
        return {"scale": req(f"{prefix}.weight"), "bias": req(f"{prefix}.bias")}

    types = "embeddings.token_type_embeddings.weight"
    params = {
        "word_embeddings": {"embedding": req("embeddings.word_embeddings.weight")},
        "position_embeddings": {"embedding": req("embeddings.position_embeddings.weight")},
        "token_type_embeddings": {
            "embedding": req(types) if types in sd
            else np.zeros((config.type_vocab_size, config.hidden_size), np.float32)
        },
        "embeddings_norm": norm("embeddings.LayerNorm"),
    }
    for i in range(config.num_layers):
        base = f"encoder.layer.{i}"
        params[f"layer_{i}"] = {
            "attention": {
                "query": dense(f"{base}.attention.self.query"),
                "key": dense(f"{base}.attention.self.key"),
                "value": dense(f"{base}.attention.self.value"),
                "output": dense(f"{base}.attention.output.dense"),
            },
            "attention_norm": norm(f"{base}.attention.output.LayerNorm"),
            "intermediate": dense(f"{base}.intermediate.dense"),
            "ffn_output": dense(f"{base}.output.dense"),
            "ffn_norm": norm(f"{base}.output.LayerNorm"),
        }
    return params


def convert_bi_encoder(state_dict, config: BertConfig) -> dict:
    """Full parameter tree of the BiEncoder (student)."""
    return {"params": {"encoder": convert_encoder_params(state_dict, config)}}


def convert_cross_encoder(state_dict, config: BertConfig) -> dict:
    """Full parameter tree of the CrossEncoder (teacher). Head mapping:
    XLM-R ``classifier.dense`` -> ``pooler``, ``classifier.out_proj`` ->
    ``classifier``; a BERT-style ``pooler.dense`` + ``classifier`` also."""
    sd = _strip_prefix(state_dict)
    encoder = convert_encoder_params(state_dict, config)

    def dense_from(*names):
        for name in names:
            if f"{name}.weight" in sd:
                return {"kernel": sd[f"{name}.weight"].T, "bias": sd[f"{name}.bias"]}
        raise WeightConversionError(f"no head weight among {names}")

    return {
        "params": {
            "encoder": encoder,
            "pooler": dense_from("classifier.dense", "pooler.dense"),
            "classifier": dense_from("classifier.out_proj", "classifier"),
        }
    }


def read_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array, BF16 as its
    ``uint16`` bits. Raises :class:`WeightConversionError` for a malformed
    file."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise WeightConversionError(f"{path}: not a safetensors file")
    n = int.from_bytes(raw[:8], "little")
    try:
        header = json.loads(raw[8 : 8 + n])
    except (UnicodeDecodeError, ValueError) as e:
        raise WeightConversionError(f"{path}: unreadable safetensors header: {e}") from e
    body = memoryview(raw)[8 + n :]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info.get("dtype"))
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if dtype is None or not 0 <= begin <= end <= len(body):
            raise WeightConversionError(f"{path}: bad entry {name!r}: {info}")
        arr = np.frombuffer(body[begin:end], dtype=dtype)
        if arr.size != int(np.prod(shape, dtype=np.int64)):
            raise WeightConversionError(f"{path}: {name!r} holds {arr.size} values, not {shape}")
        out[name] = arr.reshape(shape).copy()
    return out


# Flax's msgpack extension codes (flax.serialization._MsgpackExtType)
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# the numpy dtype names Flax writes for an ndarray; bfloat16 comes back as its
# uint16 bits viewed as torch.bfloat16 (numpy has no bfloat16 without ml_dtypes)
_MSGPACK_DTYPES = {
    name: np.dtype(name).newbyteorder("<")
    for name in ("float64", "float32", "float16", "int64", "int32", "int16", "int8",
                 "uint64", "uint32", "uint16", "uint8", "bool", "complex64", "complex128")
}


class _MsgpackReader:
    """A cursor over msgpack bytes: one :meth:`value` a call. Every read is
    bounds-checked, so a truncated buffer raises :class:`ModelLoadError`."""

    def __init__(self, raw: bytes | memoryview, where: str):
        self.raw = memoryview(raw)
        self.pos = 0
        self.where = where

    def fail(self, what: str):
        raise ModelLoadError(f"{self.where}: {what} at byte {self.pos}")

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.raw):
            self.fail(f"truncated msgpack ({n} bytes wanted, {len(self.raw) - self.pos} left)")
        out = self.raw[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:  # positive fixint
            return b
        if b >= 0xE0:  # negative fixint
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                   0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        if b in lengths:
            n = self.unpack(lengths[b])
            if b <= 0xC6:  # bin 8 / 16 / 32
                return bytes(self.take(n))
            if b <= 0xDB:  # str 8 / 16 / 32
                return self.text(n)
            return self.array(n) if b <= 0xDD else self.map(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        self.pos -= 1
        self.fail(f"unknown msgpack type byte 0x{b:02x}")

    def text(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as e:
            self.fail(f"bad utf-8 string: {e}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        body = _MsgpackReader(self.take(n), self.where)
        if code == _EXT_COMPLEX:
            real, imag = body.value()
            return complex(real, imag)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, name, buf = body.value()
            arr = _flax_ndarray(shape, name, buf, self)
            return arr if code == _EXT_NDARRAY else arr[()]
        self.fail(f"unknown msgpack ext code {code}")


def _flax_ndarray(shape, name, buf, reader: _MsgpackReader):
    """One ndarray of Flax's encoding: ``(shape, dtype name, C-order bytes)``.
    bfloat16 comes back as a torch.bfloat16 tensor."""
    if not isinstance(shape, list) or not isinstance(buf, bytes):
        reader.fail(f"malformed ndarray ({type(shape).__name__}, {type(buf).__name__})")
    count = int(np.prod(shape, dtype=np.int64))
    if name == "bfloat16":
        dtype = np.dtype("<u2")
    elif name in _MSGPACK_DTYPES:
        dtype = _MSGPACK_DTYPES[name]
    else:
        reader.fail(f"unsupported ndarray dtype {name!r}")
    if len(buf) != count * dtype.itemsize:
        reader.fail(f"ndarray of {len(buf)} bytes is not {shape} {name}")
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return arr


def _unchunk(node, where: str):
    """Flax's form for an array over ``MAX_CHUNK_SIZE`` bytes, a dict
    ``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0":
    flat chunk, ..}}``, back to the array; other dicts are walked."""
    if not isinstance(node, dict):
        return node
    if "__msgpack_chunked_array__" in node:
        try:
            shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
            if all(isinstance(c, torch.Tensor) for c in chunks):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        except (KeyError, TypeError, ValueError, RuntimeError) as e:
            raise ModelLoadError(f"{where}: malformed chunked array: {e}") from e
    return {k: _unchunk(v, where) for k, v in node.items()}


def read_flax_msgpack(path: str | Path):
    """The tree of a Flax ``params.msgpack`` (what ``flax.serialization.
    msgpack_restore`` returns): nested dicts (and lists) of numpy arrays and
    scalars, bfloat16 leaves as torch.bfloat16 tensors. Raises
    :class:`ModelLoadError` for a truncated or malformed file, an unknown
    dtype or ext code."""
    path = Path(path)
    reader = _MsgpackReader(path.read_bytes(), str(path))
    tree = reader.value()
    if reader.pos != len(reader.raw):
        reader.fail(f"{len(reader.raw) - reader.pos} bytes after the tree")
    return _unchunk(tree, str(path))


def load_hf_checkpoint(model_dir: str | Path) -> tuple[dict, dict]:
    """Read an HF checkpoint directory -> (state_dict, HF config dict), from
    ``model.safetensors`` or ``pytorch_model.bin``."""
    model_dir = Path(model_dir)
    with open(model_dir / "config.json") as f:
        hf_cfg = json.load(f)
    st_path = model_dir / "model.safetensors"
    pt_path = model_dir / "pytorch_model.bin"
    if st_path.exists():
        sd = read_safetensors(st_path)
    elif pt_path.exists():
        try:
            sd = torch.load(pt_path, map_location="cpu", weights_only=True)
        # a truncated or foreign file (read on the CPU, so no device error)
        except (RuntimeError, EOFError, ValueError, pickle.UnpicklingError) as e:
            raise WeightConversionError(f"cannot read {pt_path}: {e}") from e
    else:
        raise WeightConversionError(f"no weights file in {model_dir}")
    return sd, hf_cfg
