"""Serving launcher of the port: greedy decoding through ``Engine``.

``python -m repro_torch.launch.serve --arch llama3.2-3b`` (or
``--arch mamba2-780m``) serves the full configuration on the card with
random bf16 weights made from seed 0; ``--smoke --device cpu`` serves the
reduced configuration on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configuration, in float32")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the kernels' plain versions")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import Engine, Request, ServeSpec, resolve_device

    device = resolve_device(args.device)
    if args.smoke:
        cfg = dataclasses.replace(configs.get_smoke(args.arch),
                                  dtype=torch.float32)
    else:
        cfg = configs.get(args.arch)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    need = args.prompt_len + args.max_new
    spec = ServeSpec(batch=args.batch, cache_len=-(-need // 16) * 16)
    eng = Engine(cfg, params, spec, device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32)
    t0 = time.perf_counter()
    for p in prompts:
        eng.submit(Request(tokens=p, max_new=args.max_new))
    results = eng.drain()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = sum(r.n_tokens for r in results.values())
    print(f"[serve] {cfg.name} on {device}: drained {len(results)} requests "
          f"({n} tokens) in {dt:.2f}s ({n / dt:.1f} tok/s); "
          f"stats {eng.stats()}; sample: {results[0].tokens[:12]}")


if __name__ == "__main__":
    main()
