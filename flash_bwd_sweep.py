#!/usr/bin/env python3
"""Design sweep of the bf16 flash backward's D = 256 pair on the card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 flash_bwd_sweep.py

It builds copies of ``csrc/flash_attention_bwd.cu`` under ``build/``,
each changed at a line the source tags ``// sweep: <name>``, and times
their dq and dk/dv kernels with ``chip_smoke.Timer`` (CUDA events, the L2
flushed before each call) at gemma2-9b's training step (B = 4, S = 1,024,
16/8 heads of 256, causal, with and without cap 50) and at one sequence
of it (B = 1, whose dk/dv splits the G = 2 q heads over a cluster of two):

- ``as_is``: the kernels as they are;
- ``no_swap``: the two warpgroups' exchange of S and dP (of S^T and dP^T
  in dk/dv) through shared memory replaced by a register copy
  (``swap_dq``, ``swap_dkdv``; the gradients wrong, the time of the rest:
  what the swap costs);
- ``nz1``: dk/dv's cluster split off at D = 256 (``nz``: one block takes
  a kv head's G q heads at every B), its gradients held against
  ``as_is``'s (another summation order over the heads).

Each variant runs twice, in the order as_is, no_swap, nz1, nz1, no_swap,
as_is. One JSON line per measurement, the card's name and power limit
first.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "flash_bwd_sweep"
SHAPES = ((4, 1024, 16, 8, 256), (1, 1024, 16, 8, 256))
MASKS = (dict(causal=True, cap=50.0), dict(causal=True))
ENTRIES = ("repro_flash_bwd_dq_wgmma", "repro_flash_bwd_dkdv_wgmma")


def variants(text: str) -> dict[str, str]:
    """variant -> the source of that copy of ``flash_attention_bwd.cu``."""
    from decode_sweep import at_tag
    copy = "    if constexpr (C::NW == 2) for (int i = 0; i < 32; ++i) " \
           "dp[i] = s[i];"
    no_swap = at_tag(at_tag(text, "swap_dq", copy, replace=True),
                     "swap_dkdv", copy, replace=True)
    nz1 = at_tag(text, "nz", "    for (int c = 2; c <= 8 && C::NW == 1 && "
                 "blocks * nz < C::PER_SM * 1LL * sms; ++c)", replace=True)
    return {"as_is": text, "no_swap": no_swap, "nz1": nz1}


def build(csrc: Path) -> dict[str, dict]:
    """Compile each copy into its own library; variant -> {entry: the C
    function, typed as in ``_build.SIGNATURES``}."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for tag, text in variants(
            (csrc / "flash_attention_bwd.cu").read_text()).items():
        src, so = OUT / f"flash_bwd_{tag}.cu", OUT / f"libflash_bwd_{tag}.so"
        src.write_text(text)
        cmds.append([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                     "-Xcompiler", "-fPIC", "-shared", "-I", str(csrc),
                     str(src), "-o", str(so)])
        libs[tag] = so
    for cmd, rc, out in _build._run_all(cmds):
        if rc:
            raise RuntimeError(f"nvcc failed:\n{out}")
    fns = {}
    for tag, so in libs.items():
        lib = ctypes.CDLL(str(so))
        fns[tag] = {}
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes = _build.SIGNATURES[name]
            fn.restype = ctypes.c_int
            fns[tag][name] = fn
    return fns


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_sweep: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops

    print(chip_smoke.nvidia_smi())
    fns = build(_build.CSRC)
    timer = chip_smoke.Timer()
    stream = _build.stream_of(timer.flush)
    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *shape: torch.randn(shape, generator=g,
                                    device="cuda").bfloat16()
    for B, S, H, KV, D in SHAPES:
        q, do, k, v = rn(B, S, H, D), rn(B, S, H, D), rn(B, S, KV, D), \
            rn(B, S, KV, D)
        for mask in MASKS:
            o, lse = ops.flash_attention_lse(q, k, v, **mask)
            delta = torch.empty((B, H, S), dtype=torch.float32,
                                device="cuda")
            tail = (B, S, S, H, KV, D, float(D ** -0.5), 1, 0, 0,
                    float(mask.get("cap", 0.0)), stream)
            grads = {}

            def run(tag: str, which: str):
                dq, dk, dv = grads.setdefault(tag, (
                    torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v)))
                if which == "dq":
                    err = fns[tag][ENTRIES[0]](
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), dq.data_ptr(), *tail)
                else:
                    err = fns[tag][ENTRIES[1]](
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), *tail)
                _build.check(err, f"flash_bwd_sweep {tag} {which}")

            run("as_is", "dq")              # Delta, which dk/dv reads
            for tag in ("as_is", "no_swap", "nz1", "nz1", "no_swap",
                        "as_is"):
                row = {"shape": [B, S, H, KV, D], "mask": mask,
                       "variant": tag}
                for which in ("dq", "dkdv"):
                    row[f"{which}_ms"] = timer(lambda: run(tag, which))
                run(tag, "dkdv")
                if tag == "nz1":
                    row["dk_dv_max_abs_diff_vs_as_is"] = [
                        float((a.float() - b.float()).abs().max())
                        for a, b in zip(grads[tag][1:], grads["as_is"][1:])]
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
