"""Hanabi training entry point of the PyTorch port.

Port of `onpolicy_tpu/scripts/train_hanabi.py` (the reference's
`train_hanabi_forward.py`: flags `--hanabi_name`, `--num_agents`); runs
on the card unless `--device cpu` is given. The policy, the buffer and
the update run on the card; the games run on the C++ engine
(`cpp/hanabi`, built with g++ into `onpolicy_torch/_build/libhanabi.so`)
through the host seat loop, or with `--use_jax_env` on the port's tensor
engine; `--use_scan_rounds` or `--use_device_collect` run the device
round loop over either (`runner/hanabi_runner.py`). `--use_eval`
evaluates on a C++ fleet of `--n_eval_rollout_threads` games every
`--eval_interval` episodes.

`scripts/train_hanabi_scripts/train_hanabi_forward.sh`, the reference
paper's Hanabi-Full run (MAPPO, feed-forward, hidden 512x2, 1000 games):

    python -m onpolicy_torch.scripts.train_hanabi --env_name Hanabi \
        --algorithm_name mappo --experiment_name check \
        --hanabi_name Hanabi-Full --num_agents 2 --seed 1 \
        --n_rollout_threads 1000 --num_mini_batch 1 --episode_length 100 \
        --num_env_steps 10000000000000 --ppo_epoch 15 --gain 0.01 \
        --lr 7e-4 --critic_lr 1e-3 --hidden_size 512 --layer_N 2 \
        --entropy_coef 0.015

`train_hanabi_full.sh` adds `--use_eval` (and 1e10 steps);
`train_hanabi_device.sh` is rMAPPO with `--use_scan_rounds --use_jax_env`
and `--log_interval 1 --save_interval 5`.

`CONFIGS` holds the flags of train_hanabi_device.sh, of
train_hanabi_forward.sh and of the JAX package's Hanabi bench
configuration (`bench.py:188-244`: feed-forward MAPPO in bf16 at the
same width, fleets, T and epochs on the device engine), without a step
count, for `chip_smoke.py`, `profile_episode.py` and `learning_check.py`.
"""
from __future__ import annotations

import sys

from onpolicy_torch.config import (Config, apply_wandb_sweep,
                                   canonicalize_algorithm, get_config)
from onpolicy_torch.utils.run_dir import MetricsLogger, make_run_dir

_FULL_WIDTH = ["--env_name", "Hanabi", "--hanabi_name", "Hanabi-Full",
               "--num_agents", "2", "--n_rollout_threads", "1000",
               "--num_mini_batch", "1", "--episode_length", "100",
               "--ppo_epoch", "15", "--gain", "0.01", "--lr", "7e-4",
               "--critic_lr", "1e-3", "--hidden_size", "512",
               "--layer_N", "2", "--entropy_coef", "0.015"]
_DEVICE_ENGINE = ["--use_scan_rounds", "--use_jax_env"]
CONFIGS = {
    # scripts/train_hanabi_scripts/train_hanabi_device.sh
    "hanabi_device": _FULL_WIDTH + _DEVICE_ENGINE + [
        "--algorithm_name", "rmappo", "--seed", "1", "--log_interval", "1",
        "--save_interval", "5"],
    # bench.py:188-244
    "bench_hanabi_width": _FULL_WIDTH + _DEVICE_ENGINE + [
        "--algorithm_name", "mappo", "--use_bf16"],
    # scripts/train_hanabi_scripts/train_hanabi_forward.sh: the C++ engine
    # through the host seat loop
    "hanabi_forward": _FULL_WIDTH + ["--algorithm_name", "mappo",
                                     "--experiment_name", "check", "--seed",
                                     "1"],
}


def parse_args(argv):
    p = get_config()
    p.add_argument("--hanabi_name", type=str, default="Hanabi-Small")
    return p.parse_args(argv)


def config_from_args(argv) -> Config:
    ns = parse_args(argv)
    overrides = {k: v for k, v in vars(ns).items()
                 if k in Config.__dataclass_fields__}
    overrides.update(env_name="Hanabi", scenario_name=ns.hanabi_name)
    return canonicalize_algorithm(
        apply_wandb_sweep(Config(**overrides))).validate()


def main(argv=None):
    from onpolicy_torch.envs.hanabi.hanabi_env import HanabiVecEnv
    from onpolicy_torch.runner.hanabi_runner import HanabiRunner
    cfg = config_from_args(argv if argv is not None else sys.argv[1:])
    eval_env = None
    if cfg.use_eval:
        eval_env = HanabiVecEnv(
            cfg.scenario_name, cfg.num_agents, cfg.n_eval_rollout_threads,
            seed=cfg.seed * 50000,
            use_obs_instead_of_state=cfg.use_obs_instead_of_state)
    runner = HanabiRunner(cfg, eval_env=eval_env)
    run_dir = make_run_dir(cfg)
    logger = MetricsLogger(run_dir, cfg)
    try:
        state, history = runner.run(log_fn=logger,
                                    save_dir=run_dir / "models")
    finally:
        logger.close()
        if eval_env is not None:
            eval_env.close()
    return state, history


if __name__ == "__main__":
    main(sys.argv[1:])
