"""Seeded random weights, drawn on the device in a few large calls.

The tree has the Flax layout that the program's ``params`` argument takes
(dense kernels ``[in, out]`` with a bias, layer norms' ``scale`` and ``bias``,
embedding tables), and the plain reference reads the same tree. One normal
draw from a generator on the device fills every matrix, each slice scaled by
``1 / sqrt(fan_in)`` (embeddings by ``1 / sqrt(hidden)``); biases are zero
and layer norms the identity. The same seed on the same device gives the
same tree again.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.bert import Arch


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of a run's randomness."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *stream]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _shapes(arch: Arch, cross_encoder: bool) -> list[tuple[str, tuple[int, ...], float]]:
    """(path, shape, std) of every randomly drawn matrix, in draw order."""
    H, inter = arch.hidden, arch.intermediate
    out = [
        ("encoder/word_embeddings/embedding", (arch.vocab, H), 1 / math.sqrt(H)),
        ("encoder/position_embeddings/embedding", (arch.positions, H), 1 / math.sqrt(H)),
        ("encoder/token_type_embeddings/embedding", (arch.type_vocab, H), 1 / math.sqrt(H)),
    ]
    for i in range(arch.layers):
        for name in ("query", "key", "value", "output"):
            out.append((f"encoder/layer_{i}/attention/{name}/kernel", (H, H), 1 / math.sqrt(H)))
        out.append((f"encoder/layer_{i}/intermediate/kernel", (H, inter), 1 / math.sqrt(H)))
        out.append((f"encoder/layer_{i}/ffn_output/kernel", (inter, H), 1 / math.sqrt(inter)))
    if cross_encoder:
        out.append(("pooler/kernel", (H, H), 1 / math.sqrt(H)))
        out.append(("classifier/kernel", (H, 1), 1 / math.sqrt(H)))
    return out


def _put(tree: dict, path: str, value) -> None:
    node = tree
    *parents, leaf = path.split("/")
    for key in parents:
        node = node.setdefault(key, {})
    node[leaf] = value


def draw_tree(arch: Arch, seed: int, device, cross_encoder: bool = False) -> dict:
    shapes = _shapes(arch, cross_encoder)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    offset = 0
    for path, shape, std in shapes:
        n = math.prod(shape)
        _put(tree, path, flat[offset:offset + n].view(shape).mul_(std))
        offset += n
    H = arch.hidden

    def zeros(n):
        return torch.zeros(n, device=device)

    def norm(path):
        _put(tree, f"{path}/scale", torch.ones(H, device=device))
        _put(tree, f"{path}/bias", zeros(H))

    norm("encoder/embeddings_norm")
    for i in range(arch.layers):
        pre = f"encoder/layer_{i}"
        for name in ("query", "key", "value", "output"):
            _put(tree, f"{pre}/attention/{name}/bias", zeros(H))
        _put(tree, f"{pre}/intermediate/bias", zeros(arch.intermediate))
        _put(tree, f"{pre}/ffn_output/bias", zeros(H))
        norm(f"{pre}/attention_norm")
        norm(f"{pre}/ffn_norm")
    if cross_encoder:
        _put(tree, "pooler/bias", zeros(H))
        _put(tree, "classifier/bias", zeros(1))
    return tree
