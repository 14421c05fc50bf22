"""Training entry point of the port, as ``repro/launch/train.py``.

  * ``--mode llm`` — A3C token-level training of a (reduced or full)
    backbone on the synthetic TokenMDP pipeline, on one device.
  * ``--mode rl``  — the paper's asynchronous actor-learners; not ported
    yet (ROADMAP.md, queue 1, slice 4) and raises.

``--device`` defaults to the card (``cuda``); ``--device cpu`` runs the
kernels' plain versions on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --mode llm \\
      --arch yi-6b --reduced --steps 3 --seq 128 --batch 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

_RL_ITEM = "see ROADMAP.md, queue 1, slice 4: the paper's RL loop"


def run_llm(args) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.core import llm_a3c, prng
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.device import resolve
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt_mod

    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_params(cfg, args.seed, dev)
    opt = opt_mod.OPTIMIZERS[args.optimizer]()
    opt_state = opt.init(params)
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=args.seq,
                         global_batch=args.batch, device=str(dev))
    train_step = llm_a3c.make_train_step(cfg, opt, lr0=args.lr,
                                         total_steps=args.steps)
    data_key = prng.key(args.seed + 2)      # the JAX CLI's key
    history = []
    t0 = time.time()
    for step in range(args.steps):
        batch = pipe.batch(data_key, step)
        params, opt_state, metrics = train_step(params, opt_state, batch,
                                                step)
        if step % max(1, args.steps // 20) == 0 or step == args.steps - 1:
            rec = {"step": step,
                   "loss": float(metrics["loss"]),
                   "mean_return": float(metrics["mean_return"]),
                   "entropy": float(metrics["entropy"]),
                   "wall_s": round(time.time() - t0, 1)}
            history.append(rec)
            print(json.dumps(rec), flush=True)
    if args.checkpoint:
        from repro_torch import checkpoint
        checkpoint.save(args.checkpoint, params)
        print(f"saved params to {args.checkpoint}")
    return {"history": history}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["rl", "llm"], default="rl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--optimizer", default="shared_rmsprop",
                    choices=["shared_rmsprop", "rmsprop", "momentum_sgd"])
    ap.add_argument("--lr", type=float, default=7e-3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu (plain versions)")
    # llm
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    if args.mode == "rl":
        raise NotImplementedError(f"--mode rl is not ported yet ({_RL_ITEM})")
    return run_llm(args)


if __name__ == "__main__":
    main()
