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
"""
from __future__ import annotations

import sys

from onpolicy_torch.config import config_from_args
from onpolicy_torch.utils.run_dir import MetricsLogger, make_run_dir


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
