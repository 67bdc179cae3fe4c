#!/usr/bin/env python3
"""The bf16 flash forward of a checkout, timed at every head dim it serves,
and its backward pair at the head dims of the tensor-core backward.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 flash_sweep.py [--src DIR] [--label NAME]

``--src`` is the root of the checkout whose kernels are timed (default:
this one); they are built there at first use. The timer
(``chip_smoke.Timer``: CUDA events, the L2 flushed before each call) and
the shapes are this script's, so two versions of the kernel, such as a
parent commit unpacked under the gitignored ``build/``, compare in one
call: run the script on parent, change, change, parent.

Cases: bf16, B x S x H/KV heads x D, each with and without the rows' lse
(``flash_attention`` and ``flash_attention_lse``): D = 128 at the serving
and training shapes of llama3.2-3b (S = 512, 4 x 1,024, one FSDP rank's
1 x 1,024, one model rank's 12/4 heads) and qwen2-moe-a2.7b's 16/16 heads;
D = 64 at S = 300 (causal, window 64) and 2 x 1,024 (chunk 256); D = 32 at
4 x 1,024, 12/4 heads; D = 256 at gemma2-9b's 16/8 heads (causal, and
window 4,096 with softcap 50); D = 120 at h2o-danube-3-4b's 32/8 heads
where the checkout's forward takes it. The backward pair
(``flash_attention_bwd``, form "bwd", from the forward's o and lse) at
D = 128 on llama3.2-3b's training shape and one FSDP rank's, D = 64 at
2 x 1,024 (chunk 256) and D = 32 at 4 x 1,024, 12/4 heads, uncapped, so
that a checkout from before the backward's softcap times the same calls;
D = 120 at h2o-danube-3-4b's step (4 x 1,024, 32/8 heads) and D = 256 at
gemma2-9b's (4 x 1,024, 16/8 heads), uncapped and with cap 50, where the
checkout's backward takes them (a checkout whose bf16 D = 256 backward
ran on the CUDA cores times that pair there).
One JSON line per case and form, after the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

CAUSAL = dict(causal=True)
# (B, S, H, KV, D, mask)
CASES = ((1, 512, 24, 8, 128, CAUSAL), (4, 1024, 24, 8, 128, CAUSAL),
         (1, 1024, 24, 8, 128, CAUSAL), (1, 1024, 12, 4, 128, CAUSAL),
         (1, 512, 16, 16, 128, CAUSAL),
         (1, 300, 8, 2, 64, CAUSAL), (1, 300, 8, 2, 64,
                                      dict(causal=True, window=64)),
         (2, 1024, 16, 2, 64, dict(causal=True, chunk=256)),
         (4, 1024, 12, 4, 32, CAUSAL),
         (1, 512, 16, 8, 256, CAUSAL),
         (1, 512, 16, 8, 256, dict(causal=True, window=4096, cap=50.0)),
         (1, 512, 32, 8, 120, dict(causal=True, window=4096)))
BWD_CASES = ((4, 1024, 24, 8, 128, CAUSAL), (1, 1024, 24, 8, 128, CAUSAL),
             (2, 1024, 16, 2, 64, dict(causal=True, chunk=256)),
             (4, 1024, 12, 4, 32, CAUSAL),
             (4, 1024, 32, 8, 120, CAUSAL),
             (4, 1024, 16, 8, 256, CAUSAL),
             (4, 1024, 16, 8, 256, dict(causal=True, cap=50.0)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT),
                    help="root of the checkout whose kernels are timed")
    ap.add_argument("--label", default="this")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_sweep: no CUDA device is visible", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels.flash_attention import ops

    print(chip_smoke.nvidia_smi())
    timer = chip_smoke.Timer()
    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    for B, S, H, KV, D, mask in CASES:
        if D not in ops.HEAD_DIMS:
            continue
        q = rn(B, S, H, D).bfloat16()
        k, v = rn(B, S, KV, D).bfloat16(), rn(B, S, KV, D).bfloat16()
        for name, fn in (("o", ops.flash_attention),
                         ("o_lse", ops.flash_attention_lse)):
            print(json.dumps({
                "label": args.label, "src": str(src), "shape": [B, S, H, KV, D],
                "mask": mask, "form": name,
                "ms": timer(lambda: fn(q, k, v, **mask))}), flush=True)
    for B, S, H, KV, D, mask in BWD_CASES:
        if D not in getattr(ops, "BWD_HEAD_DIMS", ()):
            continue
        q, do = rn(B, S, H, D).bfloat16(), rn(B, S, H, D).bfloat16()
        k, v = rn(B, S, KV, D).bfloat16(), rn(B, S, KV, D).bfloat16()
        o, lse = ops.flash_attention_lse(q, k, v, **mask)
        print(json.dumps({
            "label": args.label, "src": str(src), "shape": [B, S, H, KV, D],
            "mask": mask, "form": "bwd",
            "ms": timer(lambda: ops.flash_attention_bwd(
                q, k, v, o, do, lse, **mask))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
