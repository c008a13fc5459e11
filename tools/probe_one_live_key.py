"""How far f32 dropattn backwards sit from the exact function on batch rows
with one live key.

With one key unmasked, every query's probability on that key is 1, so the
key's dv is the sum of the L rows of g (|dv| of order sqrt(L), tens at L =
512), and any f32 computation of it carries rounding of that size. This
probe takes the inputs ``tests/test_torch_kernels_gpu.py`` ``_attn_inputs``
builds (standard normal q, k, v, g; a padding bias at bf16's min / 2) with
the first batch row fully live and the others given one live key, at p = 0,
and measures, against the same backward computed in float64:

- ``dropattn_bwd_plain`` (the plain pair the card's kernels are held to);
- with ``--device cuda``, the port's ``dropattn_bwd`` on its route (the
  streaming kernels past ``DROPATTN_TC_MAX_L``).

(The JAX package's ``_dropattn_bwd_kernel`` in interpret mode is held to the
same float64 function on these rows by ``tests/test_torch_dropattn_stream.py``
``test_one_live_key_rows_hold_f32_backwards_to_the_relative_bound``.)

For each, the largest absolute error of dq, dk and dv over the one-key
rows and over the full row, the largest ``|err| / (1 + |exact|)``, and the
largest |dv|. Prints one JSON line per shape and writes them to
``chiprun_out/probe_one_live_key.json``.

    python3 tools/probe_one_live_key.py [--device cpu|cuda] [--lengths 72 136]
        [--shapes 32,16,64,64 8,16,512,64]

``--shapes`` (B,h,L,d each) replaces the default shapes, (8, 16, L, 64)
and (4, 12, L, 32) at each of ``--lengths``. The f32 kernels divide D by
the row's sum of probabilities (csrc/dropattn_bwd.cu normalized_dsum),
which gives dq and dk of 0 on these rows up to the rounding of probs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sskd_tpu_torch.ops import attention as ta  # noqa: E402


def inputs(B, h, L, d, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, go = (torch.randn(B, h, L, d, device=device, generator=g) for _ in range(4))
    lens = torch.ones(B, dtype=torch.long, device=device)
    lens[0] = L
    keep = torch.arange(L, device=device)[None, :] < lens[:, None]
    bias = torch.where(keep, 0.0, torch.finfo(torch.bfloat16).min / 2)
    return q, k, v, go, bias


def exact_backward(q, k, v, go, bias):
    """dq, dk, dv of softmax(q k^T / sqrt(d) + bias) v in float64."""
    q, k, v, go = (x.double() for x in (q, k, v, go))
    d = q.shape[-1]
    s = q @ k.transpose(-1, -2) / d**0.5 + bias.double()[:, None, None, :]
    probs = torch.softmax(s, dim=-1)
    dv = probs.transpose(-1, -2) @ go
    dprobs = go @ v.transpose(-1, -2)
    ds = probs * (dprobs - (dprobs * probs).sum(-1, keepdim=True)) / d**0.5
    return ds @ k, ds.transpose(-1, -2) @ q, dv


def errors(got, want, one_key_rows) -> dict:
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = (a.double() - b).abs()
        out[name] = {
            "max_abs_err_one_key_rows": err[one_key_rows].max().item(),
            "max_abs_err_full_row": err[~one_key_rows].max().item(),
            "max_rel_err": (err / (1 + b.abs())).max().item(),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--lengths", type=int, nargs="+", default=[72, 136])
    ap.add_argument("--shapes", nargs="+", default=None, help="B,h,L,d each")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "probe_one_live_key.json"))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = None
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
        print(card, flush=True)
    rows = []
    shapes = ([tuple(int(x) for x in sh.split(",")) for sh in args.shapes] if args.shapes
              else [(B, h, L, d) for L in args.lengths for B, h, d in ((8, 16, 64), (4, 12, 32))])
    for B, h, L, d in shapes:
        q, k, v, go, bias = inputs(B, h, L, d, 1000 + L + d, args.device)
        one_key = torch.zeros(B, h, L, d, dtype=torch.bool, device=args.device)
        one_key[1:] = True
        want = exact_backward(q, k, v, go, bias)
        _, lse = ta.dropattn_fwd_plain(q, k, v, bias, 0.0, 3)
        entry = {"shape": [B, h, L, d], "device": args.device, "card": card,
                 "max_abs_dv_one_key_rows": want[2][one_key].abs().max().item(),
                 "plain": errors(ta.dropattn_bwd_plain(q, k, v, bias, 0.0, 3, lse, go),
                                 want, one_key)}
        if args.device == "cuda":
            entry["route"] = ta.dropattn_bwd_route(q.dtype, d, L)
            entry["kernel"] = errors(ta.dropattn_bwd(q, k, v, bias, 0.0, 3, lse, go),
                                     want, one_key)
        rows.append(entry)
        print(json.dumps(entry), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
