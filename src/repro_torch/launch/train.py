"""Training entry point of the port, as ``repro/launch/train.py``.

  * ``--mode rl``  — the paper's experiments: asynchronous
    actor-learners (T1 Hogwild or T2 sync) with one of the four
    algorithms on a batched environment and the MLP agent; on one
    ``--seed`` the same environments, actions and initial weights as the
    JAX CLI.
  * ``--mode llm`` — A3C token-level training of a (reduced or full)
    backbone on the synthetic TokenMDP pipeline, on one device: any of
    the ten configs but whisper-base, whose batches need ``enc_frames``
    the pipeline does not make (the first step fails with a KeyError
    naming them, as the JAX CLI's does).  zamba2 and xlstm need ``--seq``
    a multiple of their chunk (16 reduced, 256 full).

``--device`` defaults to the card (``cuda``); ``--device cpu`` runs the
kernels' plain versions on the CPU.

``--mode llm`` under torchrun (``WORLD_SIZE`` > 1) trains data-parallel, as
the JAX launcher does on a multi-device host (``repro/launch/train.py:89-
100``): one rank a device (NCCL for ``cuda``, gloo for ``cpu``), a
(data=world, model=1) mesh, each rank on its rows of every batch, the
gradients averaged over the ranks.  The parameters stay whole on every
rank, as the JAX launcher leaves them; a model with experts takes the
expert-parallel MoE (the ``moe_ep`` rule of ``activation_rules``).  Only
rank 0 prints.  The JAX launcher runs a batch the devices do not divide on
one device; a rank cannot, so such a batch is a ValueError.

  PYTHONPATH=src python -m repro_torch.launch.train --mode rl --env catch \\
      --algo a3c --workers 8 --frames 200000
  PYTHONPATH=src python -m repro_torch.launch.train --mode llm \\
      --arch yi-6b --reduced --steps 3 --seq 128 --batch 2 --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --mode llm --arch yi-6b --reduced --steps 3 --seq 128 --batch 4 \\
      --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time


def build_rl(args):
    """The CLI's RL run from its arguments: (algo, env, initial parameters
    on ``args.device``, RunnerConfig), as the JAX CLI builds them."""
    from repro_torch.core import agents, async_runner, prng
    from repro_torch.device import resolve
    from repro_torch.envs import make
    from repro_torch.envs.api import flatten_obs
    from repro_torch.models import atari as nets

    env = make(args.env)
    if len(env.obs_shape) > 1:
        env = flatten_obs(env)
    algo = agents.ALGORITHMS[args.algo](
        **({"continuous": True} if env.continuous else {}))
    params = nets.init_mlp_agent_params(
        prng.key(args.seed), env.obs_shape[0], env.n_actions,
        hidden=args.hidden, continuous=env.continuous,
        device=resolve(args.device))
    cfg = async_runner.RunnerConfig(
        n_workers=args.workers, t_max=args.t_max, lr0=args.lr,
        total_frames=args.frames, mode=args.runner_mode,
        optimizer=args.optimizer, shared_stats=not args.per_worker_stats,
        target_interval=args.target_interval)
    return algo, env, params, cfg


def run_rl(args) -> dict:
    from repro_torch.core import async_runner, prng

    algo, env, params, cfg = build_rl(args)
    init_state, round_fn = async_runner.make_runner(algo, env, params, cfg)
    st = init_state(prng.key(args.seed + 1))
    history = []
    t0 = time.time()
    rounds = args.frames // (cfg.n_workers * cfg.t_max)
    for i in range(rounds):
        st, m = round_fn(st)
        if i % max(1, rounds // 20) == 0 or i == rounds - 1:
            rec = {"round": i, "frames": st["frames"],
                   "ep_ret": float(m["ep_ret"]), "loss": float(m["loss"]),
                   "wall_s": round(time.time() - t0, 1)}
            history.append(rec)
            print(json.dumps(rec), flush=True)
    if args.checkpoint:
        from repro_torch import checkpoint
        checkpoint.save(args.checkpoint, st["params"])
        print(f"saved params to {args.checkpoint}")
    return {"history": history, "final_ep_ret": history[-1]["ep_ret"]}


def run_llm(args) -> dict:
    """The CLI's LLM run: on one device, or data-parallel over the ranks
    torchrun started (``WORLD_SIZE`` > 1)."""
    from repro_torch.device import resolve
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_mod

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return _train_llm(args, resolve(args.device), None)
    if args.batch % world:
        raise ValueError(f"--batch {args.batch} does not divide over the "
                         f"{world} ranks: each rank takes batch / world "
                         "rows")
    dev = mesh_mod.local_device(args.device)
    with sharding.process_group(dev):
        mesh = mesh_mod.make_debug_mesh(data=world, model=1, device=dev)
        return _train_llm(args, dev, mesh)


def _train_llm(args, dev, mesh) -> dict:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import llm_a3c, prng
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import ctx, sharding
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt_mod

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_params(cfg, args.seed, dev)
    opt = opt_mod.OPTIMIZERS[args.optimizer]()
    opt_state = opt.init(params)
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, device=str(dev), mesh=mesh)
    train_step = llm_a3c.make_train_step(cfg, opt, lr0=args.lr,
                                         total_steps=args.steps)
    data_key = prng.key(args.seed + 2)      # the JAX CLI's key
    lead = mesh is None or dist.get_rank() == 0
    scope = contextlib.ExitStack()
    if mesh is not None:
        scope.enter_context(ctx.use_mesh(mesh))
        scope.enter_context(ctx.sharding_rules(sharding.activation_rules(
            mesh, batch_size=args.batch, cfg=cfg)))
    history = []
    t0 = time.time()
    with scope:
        for step in range(args.steps):
            batch = pipe.batch(data_key, step)
            params, opt_state, metrics = train_step(params, opt_state,
                                                    batch, step)
            if step % max(1, args.steps // 20) == 0 \
                    or step == args.steps - 1:
                rec = {"step": step,
                       "loss": float(metrics["loss"]),
                       "mean_return": float(metrics["mean_return"]),
                       "entropy": float(metrics["entropy"]),
                       "wall_s": round(time.time() - t0, 1)}
                history.append(rec)
                if lead:
                    print(json.dumps(rec), flush=True)
    if args.checkpoint and lead:
        from repro_torch import checkpoint
        checkpoint.save(args.checkpoint, params)
        print(f"saved params to {args.checkpoint}")
    return {"history": history}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["rl", "llm"], default="rl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--optimizer", default="shared_rmsprop",
                    choices=["shared_rmsprop", "rmsprop", "momentum_sgd"])
    ap.add_argument("--lr", type=float, default=7e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu (plain versions)")
    # rl
    ap.add_argument("--env", default="catch")
    ap.add_argument("--algo", default="a3c",
                    choices=["a3c", "one_step_q", "one_step_sarsa",
                             "n_step_q"])
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--t-max", type=int, default=5)
    ap.add_argument("--frames", type=int, default=100_000)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--runner-mode", default="hogwild",
                    choices=["hogwild", "sync"])
    ap.add_argument("--per-worker-stats", action="store_true")
    ap.add_argument("--target-interval", type=int, default=2_000)
    # llm
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "rl":
        return run_rl(args)
    return run_llm(args)


if __name__ == "__main__":
    main()
