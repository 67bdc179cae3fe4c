"""Time the full-width serving phases of several checkouts on one card, in
turns, so that two versions are compared on one machine in one run.

    python3 serve_ab.py DIR [DIR ...]

Each DIR is a checkout of this repo (its ``src`` holds ``repro_torch``),
for example a parent commit unpacked with ``git archive`` into the
gitignored ``build/``. Each runs in a process of its own, in the order
given (pass parent, change, change, parent), and serves llama3.2-3b and
mamba2-780m through this checkout's ``chip_smoke.serve_full_width``
(phases 4 and 5: 16 requests at full width, their launch counts checked,
prefill and decode timed, one prefill and a few decode steps profiled).
Each process prints chip_smoke's lines and, for mamba2-780m, where the
host's time of a 512-token prefill goes (``host_profile``: the operations
and CUDA calls with the most self CPU time under ``torch.profiler``); the
last line is one JSON object with each run's prefill and decode times, its
prefill profile (device ms a 512-token prefill and the device's idle
share) and that host breakdown.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ARCHS = (("llama3.2-3b", "serve_full_width"),
         ("mamba2-780m", "serve_full_width_ssm"))


def one(tree: Path) -> int:
    """Serve both models with the ``repro_torch`` of ``tree``."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(Path(__file__).resolve().parent))
    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = _build.build()
    _build.lib()
    print(json.dumps({"tree": str(tree), "built_s": info.seconds,
                      "build": str(info.path.parent)}), flush=True)
    smi = chip_smoke.nvidia_smi()
    for arch, phase in ARCHS:
        chip_smoke.serve_full_width(smi, arch, phase)
    host_profile(tree)
    return 0


def host_profile(tree: Path, top: int = 15) -> None:
    """Self CPU ms per 512-token mamba2-780m prefill by operation and CUDA
    call, the largest ``top``, over 3 prefills (warm)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import Engine, ServeSpec

    cfg = configs.get("mamba2-780m")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    eng = Engine(cfg, params, ServeSpec(batch=8, cache_len=1024))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, 512))).to(eng.model.device)
    prefill = lambda: eng.model(toks, mode="prefill", cache_len=1024)
    prefill()
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            prefill()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print(json.dumps({"host_profile": str(tree), "calls": calls,
                      "wall_ms_per_call": wall,
                      "top_self_cpu_ms_per_call": [
                          [e.key[:80], e.self_cpu_time_total / 1e3 / calls,
                           e.count // calls] for e in rows[:top]]}),
          flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        return one(Path(argv[1]).resolve())
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for tree in argv:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, __file__, "--one", tree],
                             capture_output=True, text=True)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr)
        if out.returncode:
            print(f"serve_ab: {tree} failed ({out.returncode})",
                  file=sys.stderr)
            return 1
        rows = [json.loads(line) for line in out.stdout.splitlines()
                if line.startswith("{")]
        run = {"tree": tree, "seconds": time.perf_counter() - t0}
        for row in rows:
            if row.get("phase") in dict(ARCHS).values():
                run[row["model"]] = {k: row[k] for k in (
                    "prefill_ms_mean", "prefill_tok_s", "decode_step_ms_mean",
                    "decode_tok_s", "wall_s")}
            elif "host_profile" in row:
                run["mamba2_prefill_host"] = row
            elif row.get("phase") == "profile_prefill":
                run[f"{row['of']}_prefill_profile"] = {k: row[k] for k in (
                    "wall_ms_per_call", "device_ms_per_call",
                    "device_idle_share", "device_ops_per_call")}
        runs.append(run)
    print(json.dumps({"serve_ab": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
