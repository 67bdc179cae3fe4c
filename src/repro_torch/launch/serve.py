"""Serving launcher of the port: greedy decoding through ``Engine``.

``python -m repro_torch.launch.serve --arch llama3.2-3b`` (or any of
``configs.ARCHS``: ``--arch mamba2-780m``; the MoE family, ``--arch
qwen2-moe-a2.7b`` and ``--arch llama4-scout-17b-a16e``, on one rank or
under ``--ranks``/``--pods``; the dense variants ``--arch yi-6b``,
``--arch h2o-danube-3-4b`` and ``--arch gemma2-9b``, their window layers
each holding a ring of min(``--cache-len``, window) slots, llama4's
chunked layers one of min(``--cache-len``, chunk), split over the ranks
like the full-length cache where they divide it)
serves the full configuration on the card with random bf16 weights made
from seed 0; ``--layers N`` cuts its depth to the first N layers of its
plan at full width (llama4-scout's 48 layers do not fit one card: 8 hold
two of its chunked / NoPE periods in about 39 GB); ``--smoke --device
cpu`` serves the reduced configuration on the CPU:

    python -m repro_torch.launch.serve --arch gemma2-9b --batch 8 \\
        --prompt-len 6000 --max-new 32 --cache-len 8192
    python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e \\
        --layers 8 --batch 4 --prompt-len 9000 --max-new 16 \\
        --cache-len 16384

``--ranks N --pods q`` spawns N processes, q pods of N/q, that join one
gloo group on localhost; each serves on ``cuda`` (all of them on the one
card when there is one) unless ``--device cpu``. With a ``--batch`` that
divides over the N ranks the batch is sharded over them, B / N rows a
rank: 2 x ``--batch`` requests, homed in ``--home-pod`` (default: none, the
pod of the row each gets), each prefilled by its pod's ranks and migrated
with ``--migrate`` when its row lies in another pod:

    python -m repro_torch.launch.serve --ranks 4 --pods 2 --batch 8 \\
        --home-pod 0 --migrate locality_bruck

With ``--batch 1`` it serves one long-context conversation at a time, its
KV cache split over the ranks:

    python -m repro_torch.launch.serve --ranks 4 --pods 2 --batch 1 \\
        --combine locality --cache-len 32768 --prompt-len 3000

``--seq-axes data`` keeps that cache whole in every pod, split over the
pod's ranks. ``--model M`` adds a "model" tier of M ranks at each place
of the pods (tensor parallelism: each rank holds its heads, its KV heads'
cache and its vocabulary rows, of a MoE model E/M routed experts and its
shared-expert columns; ``--ranks`` counts them all), and ``--mesh
2x2x2`` names the grid as ``launch/train.py`` does, the last axes of
("pod", "data", "model"). Without ``--pods``, ``--model`` or ``--mesh``,
8 or more ranks take the JAX launcher's layout, (2, ranks // 4, 2):

    python -m repro_torch.launch.serve --ranks 8 --batch 8 --home-pod 0

serves batch-sharded over 2 x 2 DP ranks with 2 model ranks each. The
kernels are built once, here, before the ranks start. :func:`run_ranks` is
the spawning helper.
"""
from __future__ import annotations

import argparse
import dataclasses
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from datetime import timedelta

import numpy as np
import torch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, inbox, results) -> None:
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as dist
    torch.set_num_threads(1)
    fn, args = inbox.get()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=600))
    try:
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:                  # reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, fn, *args, timeout: float = 1800.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined in
    one gloo group over ``tcp://localhost``; their results in rank order.
    ``fn`` is a module-level function (it is pickled by name). A rank that
    fails, or no answer within ``timeout`` seconds, raises after every
    process is stopped. ``fn`` and ``args`` go to each rank through a
    queue once every process has started: passed as the process's own
    arguments, anything past a pipe's buffer (64 KiB of prompts or
    weights) would hold ``start()`` until that child had imported torch,
    starting the ranks one after another."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    inboxes = [ctx.Queue() for _ in range(world)]
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, inboxes[r], results))
             for r in range(world)]
    for p in procs:
        p.start()
    for inbox in inboxes:
        inbox.put((fn, args))
    out, errors, left = [None] * world, [], world
    deadline = time.monotonic() + timeout
    try:
        while left and not errors:
            try:
                rank, ok, val = results.get(timeout=5.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    errors.append(f"ranks {dead} exited without a result")
                elif time.monotonic() > deadline:
                    errors.append(f"no answer within {timeout} s")
                continue
            left -= 1
            if ok:
                out[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
    finally:
        for p in procs:
            p.join(timeout=0 if errors else 60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        for inbox in inboxes:          # a rank that died may not have read
            inbox.cancel_join_thread()
            inbox.close()
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    return out


def _grid(args) -> tuple[int, int, int]:
    """(q, pl, m): ``--mesh``; else ``--ranks`` over ``--pods`` and
    ``--model``; else from 8 ranks the JAX launcher's (2, ranks // 4, 2)."""
    from repro_torch.launch.mesh import grid_shape
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split("x"))
        return grid_shape(shape, ("pod", "data", "model")[-len(shape):])
    if args.pods is None and args.model is None and args.ranks >= 8:
        return 2, args.ranks // 4, 2
    q, m = args.pods or 1, args.model or 1
    if args.ranks % (q * m):
        raise SystemExit(f"--ranks {args.ranks} is no multiple of --pods "
                         f"{q} x --model {m}")
    return q, args.ranks // (q * m), m


def _config(args):
    from repro_torch import configs
    if args.smoke:
        cfg = dataclasses.replace(configs.get_smoke(args.arch),
                                  dtype=torch.float32)
    else:
        cfg = configs.get(args.arch)
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.n_layers:
            raise SystemExit(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.n_layers}")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def _serve_rank(rank: int, world: int, args) -> dict:
    """One rank of ``--ranks``: the engine on its grid, batch-sharded (2 x
    ``--batch`` requests) or with a split cache (three requests, one at a
    time), every request submitted at once."""
    from repro_torch.core.topology import RankGrid
    from repro_torch.models.tp import TensorParallel
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import Engine, Request, ServeSpec, resolve_device

    device = resolve_device(args.device)
    grid = RankGrid.build(*args.grid)
    cfg = _config(args)
    part = (TensorParallel.build(cfg, grid, use="serve").part
            if grid.m > 1 else None)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device, part=part)
    spec = ServeSpec(batch=args.batch, cache_len=args.cache_len,
                     combine=args.combine, migrate=args.migrate,
                     seq_axes="auto" if args.seq_axes == "auto"
                     else (args.seq_axes,))
    eng = Engine(cfg, params, spec, grid=grid, device=device)
    rng = np.random.default_rng(0)
    n = 2 * args.batch if eng.sharded else 3
    t0 = time.perf_counter()
    for _ in range(n):
        eng.submit(Request(tokens=rng.integers(0, cfg.vocab_size,
                                               args.prompt_len),
                           max_new=args.max_new, home_pod=args.home_pod))
    results = eng.drain()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return {"rank": rank, "seconds": time.perf_counter() - t0,
            "tokens": {rid: r.tokens.tolist() for rid, r in results.items()},
            "migrated": sorted(rid for rid, r in results.items()
                               if r.migrated),
            "stats": eng.stats(), "cache_len": eng.cache_len,
            "cache_offset": eng.cache_offset, "sharded": eng.sharded,
            "shards": {"/".join(n): sh.length
                       for n, sh in eng.shards.items()},
            "combine": dataclasses.asdict(eng.combine)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b",
                    help="one of configs.ARCHS; a pending one raises "
                         "naming the slice it waits for")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configuration, in float32")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the first N layers of the plan, at full "
                         "width (default: every layer)")
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the kernels' plain versions")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks the batch, or a B = 1 cache, is split over "
                         "(spawned)")
    ap.add_argument("--pods", type=int, default=None,
                    help="pods the ranks form (default 1; 2 from 8 ranks)")
    ap.add_argument("--model", type=int, default=None,
                    help="model-tier ranks at each place of the pods "
                         "(default 1; 2 from 8 ranks)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x2x2 (pod, data, model): the ranks' grid, "
                         "in place of --ranks, --pods and --model")
    ap.add_argument("--combine", default="locality",
                    choices=("locality", "xla"))
    ap.add_argument("--seq-axes", default="auto", choices=("auto", "data"))
    ap.add_argument("--migrate", default="locality_bruck",
                    choices=("locality_bruck", "multilane", "xla"),
                    help="the cross-pod cache migration's schedule")
    ap.add_argument("--home-pod", type=int, default=None,
                    help="the pod every request is homed in (default none)")
    ap.add_argument("--cache-len", type=int, default=None,
                    help="cache slots (default: prompt + new, rounded up)")
    args = ap.parse_args(argv)

    from repro_torch.serve import resolve_device
    device = resolve_device(args.device)
    args.grid = _grid(args)
    q, pl, m = args.grid
    args.ranks, args.pods = q * pl * m, q
    need = args.prompt_len + args.max_new
    if args.cache_len is None:
        args.cache_len = -(-need // (16 * q * pl)) * 16 * q * pl
    if args.ranks > 1:
        if device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build()                 # once, before the ranks start
        t0 = time.perf_counter()
        out = run_ranks(args.ranks, _serve_rank, args)
        dt = time.perf_counter() - t0
        if any(r["tokens"] != out[0]["tokens"] for r in out):
            raise SystemExit("[serve] the ranks' tokens differ")
        st = out[0]["stats"]
        n = sum(len(t) for t in out[0]["tokens"].values())
        layout = (f"batch {args.batch}, {args.batch // (q * pl)} rows a "
                  f"rank, migrate {args.migrate}" if out[0]["sharded"] else
                  f"combine {out[0]['combine']}, slots a rank "
                  f"{out[0]['shards']}")
        print(f"[serve] {args.arch} on {args.ranks} ranks ({q} x {pl} x {m} "
              f"(pod, data, model), {device}): {layout}, {args.cache_len} "
              f"slots; "
              f"{len(out[0]['tokens'])} requests ({n} tokens) in {dt:.2f}s "
              f"with start-up; sample: {out[0]['tokens'][0][:12]}")
        if out[0]["sharded"]:
            print(f"[serve] migrations {st.get('migrations', 0)}: requests "
                  f"{out[0]['migrated']}")
        keys = ("prefills", "decode_steps", "decode_tokens", "migrate_bytes",
                "migrate_nonlocal_msgs", "donor_bytes", "combine_bytes",
                "nonlocal_msgs", "staging_bytes", "tier_calls",
                "tier_nonlocal_msgs", "tier_staged_bytes")
        for r in out:
            print(f"[serve] rank {r['rank']}: " + ", ".join(
                f"{k} {r['stats'][k]}" for k in keys if k in r["stats"]))
        return

    from repro_torch.models.transformer import init_params
    from repro_torch.serve import Engine, Request, ServeSpec
    cfg = _config(args)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    spec = ServeSpec(batch=args.batch, cache_len=args.cache_len)
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
