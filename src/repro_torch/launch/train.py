"""Training launcher of the port: ``Trainer`` on one rank or on spawned gloo
ranks.

``python -m repro_torch.launch.train --arch llama3.2-3b --steps 3`` trains
the full configuration on the card (random fp32 master weights from seed
0, bf16 compute, ``SyntheticLM`` batches); ``--smoke --device cpu`` trains
the reduced configuration in fp32 on the CPU (the kernels' plain
versions). ``--layers`` cuts the depth. The dense variants train the same
way: ``--arch h2o-danube-3-4b`` at full depth, ``--arch gemma2-9b --layers
8`` (its 42 layers would hold ~185 GB of fp32 weights, gradients and AdamW
moments; 8, four window / full periods, fit one H100), and either with
``--smoke --device cpu``.

``--ranks N --pods q`` spawns N processes, q pods of N/q, joined in one
gloo group on localhost (``launch.serve.run_ranks``); each trains its rows
of the global batch on ``cuda`` (all of them on the one card when there is
one) unless ``--device cpu``:

    python -m repro_torch.launch.train --smoke --device cpu --ranks 4 \\
        --pods 2 --fsdp

prints every rank's losses (equal on every rank) and its gathers,
reduce-scatters and non-local messages. ``--arch qwen2-moe-a2.7b
--moe-dispatch locality`` (or ``xla``) trains the MoE model expert-
parallel over the ranks (``make_train_step(moe_dispatch=...)``) and
prints each rank's all-to-alls. ``--mesh 2x2x2`` takes the JAX
launcher's mesh instead (the last axes of ("pod", "data", "model"), so
``4x2`` is ("data", "model")): as many ranks, tensor-parallel over the
"model" tier; ``--model M`` adds a tier of M ranks at each place of the
``--ranks`` / ``--pods`` grid (``--ranks`` counts them all). The dense
family splits its heads, MLP columns and vocabulary over the tier, the
ssm family its SSD heads, the MoE family its routed experts and shared-
expert columns (with ``--moe-dispatch`` the experts go expert-parallel
over each model lane instead):

    python -m repro_torch.launch.train --smoke --device cpu --mesh 2x2x2 \
        --fsdp
    python -m repro_torch.launch.train --arch mamba2-780m --smoke \
        --device cpu --ranks 8 --pods 2 --model 2 --fsdp
    python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --smoke \
        --device cpu --ranks 8 --pods 2 --model 2 --fsdp \
        --moe-dispatch locality

The kernels are built once, here, before the ranks start.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch


def _config(args):
    from repro_torch import configs
    cfg = (dataclasses.replace(configs.get_smoke(args.arch),
                               dtype=torch.float32)
           if args.smoke else configs.get(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    return cfg


def _trainer_config(args):
    from repro_torch.train import TrainerConfig
    return TrainerConfig(steps=args.steps, seq_len=args.seq_len,
                         global_batch=args.global_batch, log_every=1,
                         grad_sync=args.grad_sync, fsdp=args.fsdp,
                         prefetch_depth=args.prefetch_depth,
                         moe_dispatch=args.moe_dispatch, lr=args.lr)


def _mesh(args) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axes) of the ranks: ``--mesh``, else ``--ranks`` over
    ``--pods`` (and ``--model``)."""
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split("x"))
        return shape, ("pod", "data", "model")[-len(shape):]
    if args.model > 1:
        return ((args.pods, args.ranks // args.pods // args.model,
                 args.model), ("pod", "data", "model"))
    return (args.pods, args.ranks // args.pods), ("pod", "data")


def _train_rank(rank: int, world: int, args) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import resolve_device
    from repro_torch.train import Trainer
    grid = make_mesh(*_mesh(args))
    tr = Trainer(_config(args), grid, _trainer_config(args),
                 device=resolve_device(args.device),
                 log=(print if rank == 0 else (lambda _: None)))
    t0 = time.perf_counter()
    tr.run()
    m = tr.artifacts.meter.take()
    art = tr.artifacts
    return {"rank": rank, "seconds": time.perf_counter() - t0,
            "losses": [h["loss"] for h in tr.metrics_history],
            "moe": (art.moe_dispatch, art.moe_transport),
            "a2a_calls": m.a2a_calls,
            "a2a_nonlocal_msgs": m.a2a_stats.nonlocal_msgs,
            "gathers": m.gathers, "reduce_scatters": m.reduce_scatters,
            "nonlocal_msgs": (m.gather_stats.nonlocal_msgs
                              + m.reduce_scatter_stats.nonlocal_msgs),
            "model_calls": m.model_calls,
            "model_nonlocal_msgs": m.model_stats.nonlocal_msgs,
            "staged_bytes": m.staged_bytes}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configuration, in float32")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-sync", default="locality",
                    choices=("locality", "locality_rd", "flat_psum", "xla"))
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--prefetch-depth", type=int, default=0)
    ap.add_argument("--moe-dispatch", default="none",
                    choices=("none", "locality", "xla"),
                    help="expert parallelism of a MoE model over the ranks")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="default cuda; cpu runs the kernels' plain versions")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks the batch is split over (spawned)")
    ap.add_argument("--pods", type=int, default=1,
                    help="pods the ranks form (ranks / pods lanes each)")
    ap.add_argument("--model", type=int, default=1,
                    help="a model tier of this many ranks at each place of "
                         "the grid (--ranks counts them all)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x2x2 (pod, data, model): the ranks' grid, "
                         "in place of --ranks, --pods and --model")
    args = ap.parse_args(argv)
    m = 1
    if not args.mesh and args.ranks % (args.pods * args.model):
        raise SystemExit(f"--ranks {args.ranks} is no multiple of --pods "
                         f"{args.pods} x --model {args.model}")
    if args.mesh or args.model > 1:
        from repro_torch.launch.mesh import grid_shape
        q, pl, m = grid_shape(*_mesh(args))
        args.ranks, args.pods = q * pl * m, q

    from repro_torch.serve import resolve_device
    device = resolve_device(args.device)
    cfg = _config(args)
    if args.ranks > 1:
        if args.ranks % args.pods:
            raise SystemExit(f"--ranks {args.ranks} is no multiple of "
                             f"--pods {args.pods}")
        dp = args.ranks // m
        if args.global_batch % dp:
            raise SystemExit(f"--global-batch {args.global_batch} does not "
                             f"split over {dp} data-parallel ranks")
        if device.type == "cuda":
            from repro_torch.kernels import _build
            _build.build()                 # once, before the ranks start
        from repro_torch.launch.serve import run_ranks
        t0 = time.perf_counter()
        out = run_ranks(args.ranks, _train_rank, args)
        dt = time.perf_counter() - t0
        if any(r["losses"] != out[0]["losses"] for r in out):
            raise SystemExit("[train] the ranks' losses differ")
        shape, axes = _mesh(args)
        print(f"[train] {cfg.name} ({cfg.n_layers} layers) on {args.ranks} "
              f"ranks ({'x'.join(map(str, shape))} over {','.join(axes)}, "
              f"{device}), grad_sync {args.grad_sync}, fsdp {args.fsdp}, "
              f"prefetch {args.prefetch_depth}, moe dispatch "
              f"{'/'.join(out[0]['moe']).strip('/')}: losses "
              f"{out[0]['losses']} in {dt:.2f}s with start-up")
        for r in out:
            print(f"[train] rank {r['rank']}: all-to-alls {r['a2a_calls']} "
                  f"(non-local msgs {r['a2a_nonlocal_msgs']}), "
                  f"gathers {r['gathers']}, "
                  f"reduce-scatters {r['reduce_scatters']}, non-local msgs "
                  f"{r['nonlocal_msgs']}, model-tier calls "
                  f"{r['model_calls']} (non-local msgs "
                  f"{r['model_nonlocal_msgs']}), staged bytes "
                  f"{r['staged_bytes']}")
        return

    from repro_torch.train import Trainer
    tr = Trainer(cfg, None, _trainer_config(args), device=device)
    t0 = time.perf_counter()
    out = tr.run()
    print(f"[train] {cfg.name} ({cfg.n_layers} layers) on {device}: {out} in "
          f"{time.perf_counter() - t0:.2f}s")


if __name__ == "__main__":
    main()
