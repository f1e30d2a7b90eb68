"""The JAX package's Hanabi-Small learning curve on the C++ engine.

    JAX_PLATFORMS=cpu python -m diagnostics.jax_hanabi_small_host_curve \
        [--episodes 8]

A one-off measurement of the reference, not a tool of the port (which
imports no JAX): it trains the configuration that RESULTS.md:137-138
names (MAPPO, Hanabi-Small, 2 agents, 256 fleets, hidden 256x2, the JAX
defaults for every other flag) on the C++ engine through the host seat
loop, the engine RESULTS.md:135-138 puts the figure beside, with
`onpolicy_tpu.runner.hanabi_runner.HanabiRunner` for `--episodes`
episodes of 200 seat rounds, on whatever JAX platform is set, and prints
one JSON row per logged episode: buffer steps, true steps, average_score.
`onpolicy_torch/scripts/learning_check.py --runs hanabi_small_host`
trains the port on the same flags; `diagnostics/jax_hanabi_small_curve.py`
is the same on the pure-JAX engine.
"""
from __future__ import annotations

import argparse
import json
import sys

import jax

from onpolicy_tpu.config import config_from_args
from onpolicy_tpu.runner.hanabi_runner import HanabiRunner


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--episodes", type=int, default=8)
    args = ap.parse_args(argv)
    fleets, rounds = 256, 200
    cfg = config_from_args([
        "--algorithm_name", "mappo", "--scenario_name", "Hanabi-Small",
        "--num_agents", "2", "--n_rollout_threads", str(fleets),
        "--hidden_size", "256", "--layer_N", "2", "--log_interval", "1",
        "--num_env_steps", str(fleets * rounds * args.episodes)],
        env_name="Hanabi")
    keep = ("episode", "steps", "true_steps", "average_score")
    HanabiRunner(cfg).run(
        jax.random.PRNGKey(cfg.seed),
        log_fn=lambda row: print(json.dumps({k: row[k] for k in keep}),
                                 flush=True))


if __name__ == "__main__":
    main(sys.argv[1:])
