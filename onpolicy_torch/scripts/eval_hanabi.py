"""Offline Hanabi evaluation of a checkpoint (the reference's
`scripts/eval/eval_hanabi.py` and `eval_100k`).

Port of `onpolicy_tpu/scripts/eval_hanabi.py`: load a checkpoint of
`train_hanabi`, play `--eval_games` games taking the policy's mode, print
the mean score. With `--use_jax_env` the games run on the device engine
(`HanabiRunner.evaluate_device`); the C++-engine branch is ROADMAP.md
item E2 and raises.

    python -m onpolicy_torch.scripts.eval_hanabi --model_dir <ckpt-dir> \
        --hanabi_name Hanabi-Full --num_agents 2 --algorithm_name rmappo \
        --hidden_size 512 --layer_N 2 --n_rollout_threads 1000 \
        --use_jax_env --eval_games 100000
"""
from __future__ import annotations

import sys

from onpolicy_torch.scripts.train_hanabi import config_from_args


def main(argv=None):
    import argparse

    from onpolicy_torch.runner.hanabi_runner import E2, HanabiRunner
    from onpolicy_torch.utils import checkpoint as ckpt
    argv = list(argv if argv is not None else sys.argv[1:])
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--eval_games", type=int, default=100_000)
    ns, rest = ap.parse_known_args(argv)
    cfg = config_from_args(rest)
    if not cfg.use_jax_env:
        raise NotImplementedError(
            f"Hanabi evaluation on the C++ engine is not ported yet ({E2}); "
            "pass --use_jax_env")
    # evaluation collects nothing: the runner's device loop flag is moot
    runner = HanabiRunner(cfg.replace(use_scan_rounds=True))
    state = runner.algo.init_state(runner.init_generator, runner.device)
    if cfg.model_dir:
        state, _, _ = ckpt.restore(cfg.model_dir, state, runner.device, {})
    score = runner.evaluate_device(state, ns.eval_games)
    print(f"eval_average_score over {ns.eval_games} games: {score:.3f}")
    return score


if __name__ == "__main__":
    main(sys.argv[1:])
