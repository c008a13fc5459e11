"""Tensor-parallel layers for the cross-encoder teacher (port of
sskd_tpu/parallel/tp.py).

Megatron's layout over the devices of one mesh axis
(``mesh.devices_along(axis)``), inside one process:

- attention ``query``, ``key``, ``value`` and the FFN ``intermediate``:
  weights and biases split by output columns, so shard ``j`` holds heads
  ``[j h/ip, (j + 1) h/ip)`` and FFN columns ``[j I/ip, (j + 1) I/ip)``;
- attention ``output`` and ``ffn_output``: weights split by input rows (the
  matching heads and FFN columns); each shard's partial product goes to the
  first device, the partials are summed there in shard order and the bias
  is added once;
- embeddings, layer norms, pooler and classifier: one copy on the first
  device.

Each shard is a ``TransformerLayer`` of the encoder's own modules cut to its
heads and columns, and its work runs under ``torch.cuda.device(shard)``: its
attention is the encoder's (the ``flash_attn_fwd`` kernel at
``L >= FLASH_MIN_L``, plain attention below), launched on the shard's
device, and its products use the ``Linear``'s cached casts. The JAX package places
the parameters under ``NamedSharding``s and lets XLA insert the
collectives; here :func:`shard_params_tp` returns a copy of the module whose
encoder layers are :class:`TensorParallelLayer`s, and the caller's module is
left as it was.

Recorded divergences: a column split cuts whole heads, so ``num_heads`` and
``intermediate_size`` must divide by the axis size (JAX cuts the hidden
dimension anywhere and reshards), else ``ValueError``; and the layers are
for scoring: they take no dropout, and the teacher's trainer refuses a
tensor-parallel teacher.
"""

from __future__ import annotations

import copy
from dataclasses import replace

import torch
from torch import nn

from sskd_tpu_torch.models.bert import Linear, TransformerLayer
from sskd_tpu_torch.parallel.mesh import Mesh, on_device

COLUMN_SPLIT_KERNELS = ("query", "key", "value", "intermediate")
ROW_SPLIT_KERNELS = ("output", "ffn_output")


def _copy(t: torch.Tensor, device: torch.device) -> nn.Parameter:
    """A parameter of its own on ``device`` holding ``t`` (a slice)."""
    return nn.Parameter(t.detach().clone(memory_format=torch.contiguous_format).to(device),
                        requires_grad=False)


def _linear(weight, bias, compute_dtype: torch.dtype, device: torch.device) -> Linear:
    """A ``Linear`` holding copies of ``weight`` and ``bias`` (None: no
    bias) on ``device``."""
    with torch.device("meta"):
        lin = Linear(weight.shape[1], weight.shape[0], compute_dtype)
    lin.weight = _copy(weight, device)
    lin.bias = None if bias is None else _copy(bias, device)
    return lin


def _shard(layer, cfg, j: int, ip: int, device: torch.device) -> TransformerLayer:
    """Shard ``j`` of ``ip`` of ``layer`` on ``device``: a ``TransformerLayer``
    of ``num_heads / ip`` heads and ``I / ip`` FFN columns, whose row-split
    ``output`` and ``ffn_output`` have no bias. Its ``attention`` and ``ffn``
    are called; its norms stay with the caller, on the first device."""
    attn, cd = layer.attention, layer.attention.query.compute_dtype
    H, inter = attn.query.out_features, layer.intermediate.out_features
    heads = slice(j * H // ip, (j + 1) * H // ip)
    cols = slice(j * inter // ip, (j + 1) * inter // ip)
    with torch.device("meta"):
        shard = TransformerLayer(replace(cfg, num_heads=cfg.num_heads // ip,
                                         intermediate_size=inter // ip, compute_dtype=cd))
    for name in ("query", "key", "value"):
        lin = getattr(attn, name)
        setattr(shard.attention, name, _linear(lin.weight[heads], lin.bias[heads], cd, device))
    shard.attention.output = _linear(attn.output.weight[:, heads], None, cd, device)
    shard.intermediate = _linear(layer.intermediate.weight[cols], layer.intermediate.bias[cols],
                                 cd, device)
    shard.ffn_output = _linear(layer.ffn_output.weight[:, cols], None, cd, device)
    shard.attention_norm = shard.ffn_norm = None
    return shard


class TensorParallelLayer(nn.Module):
    """A ``TransformerLayer`` whose matrix products are split over
    ``devices``; the residual stream, the norms and the row-split biases
    stay on ``devices[0]``. Same call as the layer it replaces; eval only."""

    def __init__(self, layer, cfg, devices: list[torch.device]):
        super().__init__()
        self.devices = list(devices)
        ip = len(self.devices)
        self.compute_dtype = layer.attention.query.compute_dtype
        self.shards = nn.ModuleList(_shard(layer, cfg, j, ip, d)
                                    for j, d in enumerate(self.devices))
        first = self.devices[0]
        self.output_bias = _copy(layer.attention.output.bias, first)
        self.ffn_output_bias = _copy(layer.ffn_output.bias, first)
        self.attention_norm = copy.deepcopy(layer.attention_norm).to(first)
        self.ffn_norm = copy.deepcopy(layer.ffn_norm).to(first)

    def _reduce(self, parts: list[torch.Tensor], bias: torch.Tensor) -> torch.Tensor:
        """The partial products summed on the first device in shard order,
        then the bias once."""
        total = parts[0].float()
        for part in parts[1:]:
            total = total + part.float()
        return (total + bias.float()).to(self.compute_dtype)

    def forward(self, hidden, attn_bias, seeds=None) -> torch.Tensor:
        if seeds is not None:
            raise RuntimeError("tensor-parallel layers are for scoring: they take no dropout")
        first = self.devices[0]
        parts = []
        for shard, dev in zip(self.shards, self.devices):
            with on_device(dev):
                parts.append(shard.attention(hidden.to(dev), attn_bias.to(dev)).to(first))
        hidden = self.attention_norm(hidden + self._reduce(parts, self.output_bias))
        parts = []
        for shard, dev in zip(self.shards, self.devices):
            with on_device(dev):
                parts.append(shard.ffn(hidden.to(dev)).to(first))
        return self.ffn_norm(hidden + self._reduce(parts, self.ffn_output_bias))

    def unsharded_state_dict(self) -> dict[str, torch.Tensor]:
        """The ``TransformerLayer`` state this layer was cut from, on the CPU."""
        def cat(name, dim):
            return torch.cat([s.get_parameter(name).detach().cpu() for s in self.shards], dim=dim)

        state = {f"attention.{n}.{p}": cat(f"attention.{n}.{p}", 0)
                 for n in ("query", "key", "value") for p in ("weight", "bias")}
        state.update({
            "attention.output.weight": cat("attention.output.weight", 1),
            "attention.output.bias": self.output_bias.detach().cpu(),
            "intermediate.weight": cat("intermediate.weight", 0),
            "intermediate.bias": cat("intermediate.bias", 0),
            "ffn_output.weight": cat("ffn_output.weight", 1),
            "ffn_output.bias": self.ffn_output_bias.detach().cpu(),
        })
        for norm in ("attention_norm", "ffn_norm"):
            for p, t in getattr(self, norm).state_dict().items():
                state[f"{norm}.{p}"] = t.detach().cpu()
        return state


def is_tensor_parallel(module: nn.Module) -> bool:
    return any(isinstance(m, TensorParallelLayer) for m in module.encoder.layers)


def shard_params_tp(module: nn.Module, mesh: Mesh, axis: str = "index") -> nn.Module:
    """A copy of a ``CrossEncoder`` or ``BiEncoder`` split Megatron-style
    over the devices of ``axis`` (module docstring); ``module`` is left as
    it was. Raises ``ValueError`` when the heads or the FFN width do not
    divide by the axis size."""
    devices = mesh.devices_along(axis)
    ip, cfg = len(devices), module.config
    for what, n in (("num_heads", cfg.num_heads), ("intermediate_size", cfg.intermediate_size)):
        if n % ip:
            raise ValueError(f"{what}={n} does not divide over {ip} tensor-parallel devices: "
                             "a shard holds whole heads")
    if is_tensor_parallel(module):
        raise ValueError("the module is already tensor-parallel")
    layers = module.encoder.layers
    module.encoder.layers = nn.ModuleList()  # copied below, shard by shard
    try:
        tp = copy.deepcopy(module).to(devices[0])
    finally:
        module.encoder.layers = layers
    tp.encoder.layers = nn.ModuleList(TensorParallelLayer(layer, cfg, devices)
                                     for layer in layers)
    return tp.eval()


def unsharded_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """The state dict of the module a tensor-parallel one was cut from."""
    state = {}
    for name, t in module.state_dict().items():
        if not name.startswith("encoder.layers."):
            state[name] = t.detach().cpu()
    for i, layer in enumerate(module.encoder.layers):
        sub = (layer.unsharded_state_dict() if isinstance(layer, TensorParallelLayer)
               else {k: v.detach().cpu() for k, v in layer.state_dict().items()})
        state.update({f"encoder.layers.{i}.{k}": v for k, v in sub.items()})
    return state


def tp_sharding_summary(module: nn.Module) -> dict[str, int]:
    """Parameters by placement, counted as the JAX package counts the
    leaves of the same tree: ``column`` (split weights of the column
    layers), ``row`` (split weights of the row layers), ``bias_split`` (the
    column layers' biases) and ``replicated`` (the rest)."""
    out = {"replicated": 0, "column": 0, "row": 0, "bias_split": 0}
    for name, _ in module.named_parameters():
        if not name.startswith("encoder.layers."):
            out["replicated"] += 1
    for layer in module.encoder.layers:
        if not isinstance(layer, TensorParallelLayer):
            out["replicated"] += sum(1 for _ in layer.parameters())
            continue
        out["column"] += len(COLUMN_SPLIT_KERNELS)
        out["bias_split"] += len(COLUMN_SPLIT_KERNELS)
        out["row"] += len(ROW_SPLIT_KERNELS)
        out["replicated"] += len(ROW_SPLIT_KERNELS)  # the row layers' biases
        out["replicated"] += sum(1 for _ in layer.attention_norm.parameters())
        out["replicated"] += sum(1 for _ in layer.ffn_norm.parameters())
    return out
