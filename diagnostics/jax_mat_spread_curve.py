"""The JAX package's own MAT learning curve on simple_spread, for comparison.

    JAX_PLATFORMS=cpu python -m diagnostics.jax_mat_spread_curve \
        [--steps 20000000] [--lr 5e-4]

A one-off measurement of the reference, not a tool of the port (which
imports no JAX): it trains `scripts/train_other_algo/train_mpe_mat.sh`'s
flags (MAT, simple_spread, 3 agents, seed 1, 128 threads, T=25, 10 PPO
epochs, n_block 1, n_embd 64, n_head 1; `--lr` 5e-4 as the script sets
it, or 7e-4 as RESULTS.md:92-93's spread recipe) through
`onpolicy_tpu.runner.shared_runner.SharedRunner`, logging every 5
episodes as the port's `learning_check.py` does, on whatever JAX platform
is set. It prints one JSON row per logged episode (steps and
average_episode_rewards) and, at the end, the level at each million
steps: the mean of the last 10 logged rows up to it, as
`learning_check.level` reads the port's run.
"""
from __future__ import annotations

import argparse
import json
import sys

import jax

from onpolicy_tpu.config import config_from_args


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20_000_000)
    ap.add_argument("--lr", default="5e-4")
    args = ap.parse_args(argv)
    from onpolicy_tpu.runner.shared_runner import SharedRunner
    cfg = config_from_args([
        "--env_name", "MPE", "--algorithm_name", "mat",
        "--scenario_name", "simple_spread", "--num_agents", "3",
        "--num_landmarks", "3", "--seed", "1", "--n_rollout_threads", "128",
        "--episode_length", "25", "--ppo_epoch", "10", "--lr", args.lr,
        "--n_block", "1", "--n_embd", "64", "--n_head", "1",
        "--num_env_steps", str(args.steps), "--log_interval", "5"])
    rows = []

    def log(row):
        if "average_episode_rewards" not in row:
            return
        rows.append({"steps": row["steps"],
                     "average_episode_rewards":
                     float(row["average_episode_rewards"])})
        print(json.dumps(rows[-1]), flush=True)
    SharedRunner(cfg).run(jax.random.PRNGKey(cfg.seed), log_fn=log)
    levels = {}
    for m in range(1_000_000, args.steps + 1, 1_000_000):
        upto = [r["average_episode_rewards"] for r in rows
                if r["steps"] <= m][-10:]
        if upto:
            levels[m] = sum(upto) / len(upto)
    print(json.dumps({"lr": args.lr, "levels": levels}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
