"""A3C at LLM scale, as ``examples/llm_policy_a3c.py``: the paper's
algorithm driving a backbone as a token-level policy (TokenMDP), on the
reduced Granite-MoE config by default, so the run takes the MoE router and
its load-balance loss.  Shared RMSProp at lr0 3e-3, TokenPipeline batches
of 4 x 64 tokens; loss, mean return and aux are printed every 10 steps.
On one seed the port draws the JAX example's initial weights and batches.

  PYTHONPATH=src python -m repro_torch.examples.llm_policy_a3c \\
      [--arch stablelm-1.6b] [--steps 60] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.core import llm_a3c, prng
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt_mod

SEQ, BATCH, LR0 = 64, 4, 3e-3
LOG_EVERY = 10


def main(argv=None):
    """Runs the example; returns each step's {"loss", "mean_return",
    "aux"} as floats."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu (plain versions)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_config(args.arch).reduced()
    params = M.init_params(cfg, 0, dev)
    opt = opt_mod.shared_rmsprop()
    opt_state = opt.init(params)
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=SEQ,
                         global_batch=BATCH, device=str(dev))
    step_fn = llm_a3c.make_train_step(cfg, opt, lr0=LR0,
                                      total_steps=10**9)
    data_key = prng.key(7)
    history = []
    for i in range(args.steps):
        batch = pipe.batch(data_key, i % 4)
        params, opt_state, m = step_fn(params, opt_state, batch, i)
        rec = {k: float(m[k]) for k in ("loss", "mean_return", "aux")}
        history.append(rec)
        if i % LOG_EVERY == 0:
            print(f"step {i:3d}  loss={rec['loss']:8.3f}  "
                  f"mean_return={rec['mean_return']:6.2f}  "
                  f"aux={rec['aux']:.4f}", flush=True)
    print("\npolicy return should trend up as the policy learns the "
          "successor-token task")
    return history


if __name__ == "__main__":
    main()
