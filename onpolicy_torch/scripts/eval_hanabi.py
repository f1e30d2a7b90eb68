"""Offline Hanabi evaluation of a checkpoint (the reference's
`scripts/eval/eval_hanabi.py` and `eval_100k`).

Port of `onpolicy_tpu/scripts/eval_hanabi.py`: load a checkpoint of
`train_hanabi`, play `--eval_games` games taking the policy's mode, print
the mean score. The games run on the runner's own fleet of
`--n_rollout_threads` games of the C++ engine (`HanabiRunner.evaluate`,
which stops after 100,000 steps however many games have finished), or
with `--use_jax_env` on the tensor engine (`HanabiRunner.evaluate_device`).
`scripts/eval_hanabi_forward.sh` (`EVAL_FORWARD` holds its flags):

    python -m onpolicy_torch.scripts.eval_hanabi --env_name Hanabi \
        --algorithm_name mappo --experiment_name check \
        --hanabi_name Hanabi-Full --num_agents 2 --seed 1 \
        --n_rollout_threads 1 --n_eval_rollout_threads 1000 \
        --num_mini_batch 4 --episode_length 100 \
        --num_env_steps 10000000000000 --ppo_epoch 15 --gain 0.01 \
        --lr 7e-4 --critic_lr 1e-3 --hidden_size 512 --layer_N 2 \
        --use_eval --use_recurrent_policy false --entropy_coef 0.015 \
        --model_dir <run>/models
"""
from __future__ import annotations

import sys

from onpolicy_torch.scripts.train_hanabi import config_from_args

# scripts/eval_hanabi_forward.sh without --model_dir
EVAL_FORWARD = [
    "--env_name", "Hanabi", "--algorithm_name", "mappo", "--experiment_name",
    "check", "--hanabi_name", "Hanabi-Full", "--num_agents", "2", "--seed",
    "1", "--n_rollout_threads", "1", "--n_eval_rollout_threads", "1000",
    "--num_mini_batch", "4", "--episode_length", "100", "--num_env_steps",
    "10000000000000", "--ppo_epoch", "15", "--gain", "0.01", "--lr", "7e-4",
    "--critic_lr", "1e-3", "--hidden_size", "512", "--layer_N", "2",
    "--use_eval", "--use_recurrent_policy", "false", "--entropy_coef",
    "0.015"]


def main(argv=None):
    import argparse

    from onpolicy_torch.runner.hanabi_runner import HanabiRunner
    from onpolicy_torch.utils import checkpoint as ckpt
    argv = list(argv if argv is not None else sys.argv[1:])
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--eval_games", type=int, default=100_000)
    ns, rest = ap.parse_known_args(argv)
    cfg = config_from_args(rest)
    if cfg.use_jax_env:
        # evaluation collects nothing: the runner's round loop is moot
        cfg = cfg.replace(use_scan_rounds=True)
    runner = HanabiRunner(cfg)
    state = runner.algo.init_state(runner.init_generator, runner.device)
    if cfg.model_dir:
        state, _, _ = ckpt.restore(cfg.model_dir, state, runner.device, {})
    if cfg.use_jax_env:
        score = runner.evaluate_device(state, ns.eval_games)
    else:
        score = runner.evaluate(state, ns.eval_games)
    print(f"eval_average_score over {ns.eval_games} games: {score:.3f}")
    return score


if __name__ == "__main__":
    main(sys.argv[1:])
