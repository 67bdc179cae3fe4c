#!/usr/bin/env python3
"""Design sweep of the port's two decode-attention kernels on the card.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 decode_sweep.py

It times, with ``chip_smoke.Timer`` (CUDA events; "cold": the L2 flushed
before each call, "warm": back-to-back calls, so the launch overlaps the
previous call) at llama3.2-3b's decode shape (B = 8, KV = 8, D = 128,
L = 1,024, bf16; G = 3, and G = 8 and G = 1 with D = 64 beside it), with
positions 64-576 (rows mid-request) and 64-79 (rows early in a request,
as in the serving phases' profiled decode steps):

1. the blocks per row (a cluster, 3 to 8) of both kernels, for each of
   three variants built from copies of the sources under ``build/``: the
   kernels as they are ("as_is"), and with more or fewer loads in flight
   per lane (the accumulation's V rows kU 16 or 4 in place of 8, for
   G > 4 8 or 2 in place of 4; the scores' K vectors kChunk 16 or 4 in
   place of 8);
2. ablations, G = 3 only: copies of the kernels cut after a phase (the
   result wrong, the time of what remains): cut1 after the kept interval
   is known, cut2 after the NEG_INF fill (scores) or the main loop
   (stats), cut3 after the main loop (scores) or the block's reduction
   (stats); and copies with one piece of the main loop taken out: the
   scores' stores of s (no_store), the accumulation's multiply-adds
   (no_fma; the other kernel runs intact under each name).

Each copy is cut or changed at a line the sources tag ``// sweep: <name>``
(kU, kChunk, cut1-3, no_store, no_fma). One JSON line per measurement;
the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "decode_sweep"


def at_tag(text: str, name: str, code: str, replace: bool = False) -> str:
    """``text`` with ``code`` put just after its one line ``// sweep: name``
    (in place of the line after it, where ``replace``)."""
    lines = text.split("\n")
    at = [i for i, ln in enumerate(lines) if ln.strip() == f"// sweep: {name}"]
    assert len(at) == 1, f"// sweep: {name} is on {len(at)} lines"
    lines[at[0] + 1:at[0] + 1 + replace] = [code]
    return "\n".join(lines)


def variants(csrc: Path) -> dict[tuple[str, str], str]:
    """(kernel, variant) -> the source of that copy, cut or changed at the
    lines the sources tag ``// sweep: <name>``."""
    src = {"decode_stats": (csrc / "decode_stats.cu").read_text(),
           "decode_scores": (csrc / "decode_scores.cu").read_text()}
    out = {(name, "as_is"): text for name, text in src.items()}
    # more or fewer loads in flight per lane: the accumulation's V rows
    # (kU), the scores' K vectors (kChunk)
    knobs = {"decode_stats": ("kU", "  constexpr int kU = G <= 4 ? 16 : 8;",
                              "  constexpr int kU = G <= 4 ? 4 : 2;"),
             "decode_scores": ("kChunk", "constexpr int kChunk = 16;",
                               "constexpr int kChunk = 4;")}
    for name, (knob, more, fewer) in knobs.items():
        out[(name, "more")] = at_tag(src[name], knob, more, replace=True)
        out[(name, "fewer")] = at_tag(src[name], knob, fewer, replace=True)
    # each kernel cut after a phase: cut1, cut2, cut3 return there
    cuts = {
        "decode_stats": ["  if (t1 == 12345) o[0] = 1.f;\n  return;",
                         "  if (lsum[0] == 12345.f) o[0] = acc[0][0][0];\n"
                         "  return;",
                         "  return;"],
        "decode_scores": ["  if (n == 12345) m[0] = sQ[0];\n  return;",
                          "  if (n == 12345) m[0] = sQ[0];\n  return;",
                          "  if (mx[0] == 12345.f) m[0] = 1.f;\n  return;"]}
    for name, codes in cuts.items():
        for i, code in enumerate(codes, 1):
            out[(name, f"cut{i}")] = at_tag(src[name], f"cut{i}", code)
    # pieces of the main loops taken out: the scores' stores of s, the
    # accumulation's multiply-adds (the other kernel intact under the name)
    out[("decode_scores", "no_store")] = at_tag(
        src["decode_scores"], "no_store",
        "      if (L < 0) srow[static_cast<size_t>(g) * L + j] = x;",
        replace=True)
    out[("decode_stats", "no_fma")] = at_tag(
        src["decode_stats"], "no_fma",
        "              acc[g][c][e] += vf[u][c][e];", replace=True)
    out[("decode_stats", "no_store")] = src["decode_stats"]
    out[("decode_scores", "no_fma")] = src["decode_scores"]
    return out


def build(csrc: Path, sources: dict) -> dict:
    """Compile each copy into its own library; (kernel, variant) -> the C
    entry point, typed as in ``_build.SIGNATURES``."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    cmds, libs = [], {}
    for (name, tag), text in sources.items():
        src, so = OUT / f"{name}_{tag}.cu", OUT / f"lib{name}_{tag}.so"
        src.write_text(text)
        cmds.append([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                     "-Xcompiler", "-fPIC", "-shared", "-I", str(csrc),
                     str(src), "-o", str(so)])
        libs[(name, tag)] = so
    for cmd, rc, out in _build._run_all(cmds):
        if rc:
            raise RuntimeError(f"nvcc failed:\n{out}")
    fns = {}
    for key, so in libs.items():
        fn = getattr(ctypes.CDLL(str(so)), f"repro_{key[0]}")
        fn.argtypes = _build.SIGNATURES[f"repro_{key[0]}"]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def warm_ms(fn, iters: int = 20) -> float:
    """Mean device ms per call of back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_stats import ops

    print(chip_smoke.nvidia_smi())
    fns = build(_build.CSRC, variants(_build.CSRC))
    timer = chip_smoke.Timer()
    stream = _build.stream_of(timer.flush)
    empty = lambda: _build.lib().repro_empty(stream)
    print(json.dumps({"empty_cold_ms": timer(empty),
                      "empty_warm_ms": warm_ms(empty)}))
    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    B, KV, L = 8, 8, 1024
    for G, D in ((3, 128), (8, 128), (1, 64)):
        for lohi in ((64, 577), (64, 80)):
            pos = torch.randint(*lohi, (B,), generator=g, device="cuda")
            q, k, v = (rn(B, 1, KV * G, D).bfloat16(),
                       rn(B, L, KV, D).bfloat16(), rn(B, L, KV, D).bfloat16())
            s, m = ops.decode_scores(q, k, pos)
            o = torch.empty((B, 1, KV * G, D), device="cuda")
            l = torch.empty((B, 1, KV * G), device="cuda")
            tags = (("as_is", "more", "fewer", "cut1", "cut2", "cut3",
                     "no_store", "no_fma") if G == 3 else ("as_is",))
            for nsplit in (3, 4, 5, 6, 8):
                for tag in tags:
                    sc = lambda: fns[("decode_scores", tag)](
                        q.data_ptr(), k.data_ptr(), pos.data_ptr(), 1, 0,
                        s.data_ptr(), m.data_ptr(), B, KV, G, L, D, nsplit,
                        D ** -0.5, 0, 0, 0, 0.0, 1, stream)
                    st = lambda: fns[("decode_stats", tag)](
                        s.data_ptr(), m.data_ptr(), v.data_ptr(),
                        pos.data_ptr(), 1, 0, 0, 0, 0, o.data_ptr(),
                        l.data_ptr(),
                        B, KV, G, L, D, nsplit, 1, stream)
                    _build.check(sc(), "decode_scores")
                    _build.check(st(), "decode_stats")
                    print(json.dumps({
                        "G": G, "D": D, "positions": [lohi[0], lohi[1] - 1],
                        "blocks_per_row": nsplit, "variant": tag,
                        "scores_cold_ms": timer(sc), "scores_warm_ms": warm_ms(sc),
                        "stats_cold_ms": timer(st), "stats_warm_ms": warm_ms(st)}))
                s, m = ops.decode_scores(q, k, pos)   # the cuts wrote over them
    return 0


if __name__ == "__main__":
    sys.exit(main())
