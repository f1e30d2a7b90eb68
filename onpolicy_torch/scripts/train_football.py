"""Google Research Football training entry point of the PyTorch port.

Port of `onpolicy_tpu/scripts/train_football.py` (the reference's
`train_football.py`): GRF's own flags (--representation, --rewards,
--share_reward, the smm sizes); the envs in the host pool
(`envs/host_vec.py`) with the 4-tuple protocol (fully observed: the
centralized state is every player's obs), the policy and the update on
the card unless `--device cpu` is given. It needs the `gfootball`
package. As JAX's, `main` hands the runner no eval env, so `--use_eval`
evaluates nothing, and saves no checkpoint.
`scripts/train_football_scripts/train_football_3v1.sh`:

    python -m onpolicy_torch.scripts.train_football --env_name Football \
        --scenario_name academy_3_vs_1_with_keeper \
        --algorithm_name rmappo --experiment_name check --seed 1 \
        --num_agents 3 --num_env_steps 25000000 --episode_length 200 \
        --representation simple115v2 --rewards scoring,checkpoints \
        --n_rollout_threads 50 --ppo_epoch 15 --num_mini_batch 2 \
        --save_interval 200000 --log_interval 200000 --use_eval \
        --eval_interval 400000 --n_eval_rollout_threads 100 \
        --eval_episodes 100

`CONFIGS["football_3v1"]` holds those flags without the step count, for
`chip_smoke.py` and `profile_episode.py`. Data parallel: under `torchrun
--standalone --nproc_per_node R ... --mesh_shape R` (or D·M ranks and
`--mesh_shape D,M`, the parameters and moments sharded along 'model')
each rank owns a pool of `n_rollout_threads` envs, as `train_smac.py`
says; rank 0 logs.
"""
from __future__ import annotations

import sys

from onpolicy_torch.config import (Config, _parse_bool, apply_wandb_sweep,
                                   canonicalize_algorithm, get_config)
from onpolicy_torch.envs.host_vec import DummyVecEnv, HostVecEnv
from onpolicy_torch.parallel import distributed
from onpolicy_torch.utils.run_dir import MetricsLogger, make_run_dir

CONFIGS = {
    # scripts/train_football_scripts/train_football_3v1.sh
    "football_3v1": [
        "--env_name", "Football", "--scenario_name",
        "academy_3_vs_1_with_keeper", "--algorithm_name", "rmappo",
        "--experiment_name", "check", "--seed", "1", "--num_agents", "3",
        "--episode_length", "200", "--representation", "simple115v2",
        "--rewards", "scoring,checkpoints", "--n_rollout_threads", "50",
        "--ppo_epoch", "15", "--num_mini_batch", "2", "--save_interval",
        "200000", "--log_interval", "200000", "--use_eval",
        "--eval_interval", "400000", "--n_eval_rollout_threads", "100",
        "--eval_episodes", "100"],
}


def parse_args(argv):
    p = get_config()
    p.add_argument("--representation", type=str, default="simple115v2")
    p.add_argument("--rewards", type=str, default="scoring,checkpoints")
    p.add_argument("--smm_width", type=int, default=96)
    p.add_argument("--smm_height", type=int, default=72)
    p.add_argument("--share_reward", nargs="?", const=True, default=True,
                   type=_parse_bool)
    p.add_argument("--eval_deterministic", nargs="?", const=True,
                   default=True, type=_parse_bool)
    # accepted for the command line's sake; stored but never read in the
    # reference (Football_Env.py:46-47)
    p.add_argument("--remove_redundancy", nargs="?", const=True,
                   default=False, type=_parse_bool)
    p.add_argument("--zero_feature", nargs="?", const=True,
                   default=False, type=_parse_bool)
    return p.parse_args(argv)


def config_from_args(argv):
    """→ (parsed flags, Config) with env_name Football."""
    ns = parse_args(argv)
    overrides = {k: v for k, v in vars(ns).items()
                 if k in Config.__dataclass_fields__}
    overrides["env_name"] = "Football"
    return ns, canonicalize_algorithm(
        apply_wandb_sweep(Config(**overrides))).validate()


def make_env_fns(ns, cfg):
    from onpolicy_torch.envs.football.football_env import FootballEnv

    def fn():
        return FootballEnv(
            scenario_name=cfg.scenario_name, num_agents=cfg.num_agents,
            representation=ns.representation, rewards=ns.rewards,
            share_reward=ns.share_reward, smm_width=ns.smm_width,
            smm_height=ns.smm_height)
    return [fn] * cfg.n_rollout_threads


def main(argv=None):
    from onpolicy_torch.envs.football.football_env import football_metrics
    from onpolicy_torch.runner.host_runner import HostSharedRunner
    ns, cfg = config_from_args(argv if argv is not None else sys.argv[1:])
    cfg = distributed.setup(cfg)
    Pool = DummyVecEnv if cfg.n_rollout_threads == 1 else HostVecEnv
    envs = Pool(make_env_fns(ns, cfg), protocol="basic")
    try:
        runner = HostSharedRunner(cfg, envs, env_metrics=football_metrics())
        if distributed.rank() != 0:
            return runner.run(log_fn=None)
        run_dir = make_run_dir(cfg)
        logger = MetricsLogger(run_dir, cfg)
        try:
            state, history = runner.run(log_fn=logger)
        finally:
            logger.close()
    finally:
        envs.close()
    return state, history


if __name__ == "__main__":
    main(sys.argv[1:])
    distributed.shutdown()
