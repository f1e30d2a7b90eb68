"""MPE training entry point of the PyTorch port.

Port of `onpolicy_tpu/scripts/train_mpe.py`: algorithm-name
canonicalization, seeding, run-dir layout; runs on the card unless
`--device cpu` is given. The flagship run (rMAPPO, simple_spread):

    python -m onpolicy_torch.scripts.train_mpe \
        --env_name MPE --algorithm_name rmappo --experiment_name check \
        --scenario_name simple_spread --num_agents 3 --num_landmarks 3 \
        --seed 1 --n_rollout_threads 128 --num_mini_batch 1 \
        --episode_length 25 --num_env_steps 20000000 --ppo_epoch 10 \
        --use_ReLU false --gain 0.01 --lr 7e-4 --critic_lr 7e-4

The JAX package's two throughput configurations (bench.py:53-75 and
:142-165), 16,384 rollout threads in bf16: feed-forward MAPPO with the
critic dedup, and rMAPPO.

    python -m onpolicy_torch.scripts.train_mpe \
        --env_name MPE --algorithm_name mappo --scenario_name simple_spread \
        --num_agents 3 --num_landmarks 3 --n_rollout_threads 16384 \
        --episode_length 25 --num_env_steps 409600000 --ppo_epoch 10 \
        --num_mini_batch 1 --lr 7e-4 --critic_lr 7e-4 --hidden_size 64 \
        --use_bf16 --use_critic_dedup

    python -m onpolicy_torch.scripts.train_mpe \
        --env_name MPE --algorithm_name rmappo --scenario_name simple_spread \
        --num_agents 3 --num_landmarks 3 --n_rollout_threads 16384 \
        --episode_length 25 --num_env_steps 409600000 --ppo_epoch 10 \
        --num_mini_batch 1 --data_chunk_length 10 --lr 7e-4 \
        --critic_lr 7e-4 --hidden_size 64 --use_bf16

`CONFIGS` holds these three as flag lists (without a step count), for
`chip_smoke.py` and `profile_episode.py`.
"""
from __future__ import annotations

import sys

from onpolicy_torch.config import config_from_args
from onpolicy_torch.utils.run_dir import MetricsLogger, make_run_dir

_SPREAD = ["--env_name", "MPE", "--scenario_name", "simple_spread",
           "--num_agents", "3", "--num_landmarks", "3", "--seed", "1",
           "--episode_length", "25", "--ppo_epoch", "10",
           "--num_mini_batch", "1", "--lr", "7e-4", "--critic_lr", "7e-4",
           "--hidden_size", "64"]
CONFIGS = {
    # the reference's train_mpe_spread.sh
    "flagship": _SPREAD + ["--algorithm_name", "rmappo",
                           "--n_rollout_threads", "128",
                           "--use_ReLU", "false", "--gain", "0.01"],
    # bench.py:53-75
    "bench_mappo": _SPREAD + ["--algorithm_name", "mappo",
                              "--n_rollout_threads", "16384",
                              "--use_bf16", "--use_critic_dedup"],
    # bench.py:142-165
    "bench_rmappo": _SPREAD + ["--algorithm_name", "rmappo",
                               "--n_rollout_threads", "16384",
                               "--data_chunk_length", "10", "--use_bf16"],
}


def main(argv=None):
    cfg = config_from_args(argv)
    if cfg.env_name != "MPE":
        raise NotImplementedError(
            f"env {cfg.env_name!r}: the port's MPE entry point takes MPE")
    if not cfg.share_policy:
        raise NotImplementedError(
            "separated policies are not ported yet (ROADMAP.md, Queue 1 "
            "item 11)")
    from onpolicy_torch.runner.shared_runner import SharedRunner

    runner = SharedRunner(cfg)
    run_dir = make_run_dir(cfg)
    logger = MetricsLogger(run_dir, cfg)
    try:
        state, history = runner.run(log_fn=logger, save_dir=run_dir / "models")
    finally:
        logger.close()
    return state, history


if __name__ == "__main__":
    main(sys.argv[1:])
