"""SMAC / SMACv2 training entry point of the PyTorch port.

Port of `onpolicy_tpu/scripts/train_smac.py` (the reference's
`train_smac.py`): env ids StarCraft2 / StarCraft2v2 (and the aliases
SMAC / SMACv2), num_agents from the map registry or from `--units`, the
SMACv2 capability distribution, the win-rate metrics. The envs run in
the shared-memory host pool (`envs/host_vec.py`, a worker process an env;
in-process for one thread), the policy and the update on the card
unless `--device cpu` is given; happo and hatrpo train through
`runner/host_separated_runner.py`, the rest through
`runner/host_runner.HostSharedRunner`. It needs the `smac` (StarCraft2)
or `smacv2` (StarCraft2v2) package and a StarCraft II installation.
`scripts/train_smac_scripts/train_smac_3s5z.sh`:

    python -m onpolicy_torch.scripts.train_smac --env_name StarCraft2 \
        --algorithm_name rmappo --experiment_name check --map_name 3s5z \
        --seed 1 --n_rollout_threads 8 --num_mini_batch 1 \
        --episode_length 400 --num_env_steps 10000000 --ppo_epoch 5 \
        --use_value_active_masks false --use_eval --eval_episodes 32

`CONFIGS` holds the flags of that script, of
`scripts/train_smacv2_scripts/train_protoss_5v5.sh` and of
`scripts/train_other_algo/train_happo.sh` (HAPPO on SMACv2 protoss 5v5),
without a step count, for `chip_smoke.py` and `profile_episode.py`. As
JAX's, `main` saves no checkpoint.

Data parallel: `torchrun --standalone --nproc_per_node R -m
onpolicy_torch.scripts.train_smac ... --mesh_shape R`, or on the 2-D
(data, model) mesh `--nproc_per_node D·M ... --mesh_shape D,M` (each
rank keeps its blocks of the parameters and moments along 'model' and
acts with the gathered ones, `parallel/mesh.py`). Each rank owns a pool
of `n_rollout_threads` envs (the global batch is D·M times that, as in
the JAX package's multi-process host path), env i of rank r seeded as
global env r·n + i; each minibatch must split over the D·M ranks; rank 0
logs and evaluates.
"""
from __future__ import annotations

import sys
from types import SimpleNamespace

from onpolicy_torch.config import (Config, _parse_bool, apply_wandb_sweep,
                                   canonicalize_algorithm, get_config)
from onpolicy_torch.envs.host_vec import DummyVecEnv, HostVecEnv
from onpolicy_torch.envs.starcraft2.smac_maps import get_map_params
from onpolicy_torch.parallel import distributed
from onpolicy_torch.runner import host_mesh
from onpolicy_torch.utils.run_dir import MetricsLogger, make_run_dir

_SMACV2 = ["--env_name", "StarCraft2v2", "--map_name", "10gen_protoss",
           "--seed", "1", "--units", "5v5", "--num_mini_batch", "1",
           "--episode_length", "400", "--ppo_epoch", "5",
           "--use_value_active_masks", "false", "--use_eval",
           "--eval_episodes", "32"]
CONFIGS = {
    # scripts/train_smac_scripts/train_smac_3s5z.sh
    "smac_3s5z": ["--env_name", "StarCraft2", "--algorithm_name", "rmappo",
                  "--experiment_name", "check", "--map_name", "3s5z",
                  "--seed", "1", "--n_rollout_threads", "8",
                  "--num_mini_batch", "1", "--episode_length", "400",
                  "--ppo_epoch", "5", "--use_value_active_masks", "false",
                  "--use_eval", "--eval_episodes", "32"],
    # scripts/train_smacv2_scripts/train_protoss_5v5.sh
    "smacv2_protoss_5v5": _SMACV2 + ["--algorithm_name", "mappo",
                                     "--experiment_name", "tune2",
                                     "--n_rollout_threads", "8"],
    # scripts/train_other_algo/train_happo.sh
    "smacv2_happo": _SMACV2 + ["--algorithm_name", "happo",
                               "--experiment_name", "test",
                               "--n_rollout_threads", "2"],
}


def parse_args(argv):
    p = get_config()
    p.add_argument("--map_name", type=str, default="3s5z")
    p.add_argument("--units", type=str, default="10v10",
                   help="SMACv2 ally-v-enemy unit counts, e.g. 10v11")
    p.add_argument("--add_center_xy", nargs="?", const=True, default=True,
                   type=_parse_bool)
    p.add_argument("--use_state_agent", nargs="?", const=True, default=True,
                   type=_parse_bool)
    p.add_argument("--use_mustalive", nargs="?", const=True, default=True,
                   type=_parse_bool)
    # EP-state ablation blocks (the reference's train_smac.py:112-118)
    for f in ("add_move_state", "add_local_obs", "add_distance_state",
              "add_xy_state", "add_visible_state", "add_enemy_action_state",
              "add_agent_id"):
        p.add_argument("--" + f, nargs="?", const=True, default=False,
                       type=_parse_bool)
    p.add_argument("--train_maps", nargs="+", default=None,
                   help="SMACv2 meta-training map list")
    p.add_argument("--eval_maps", nargs="+", default=None,
                   help="SMACv2 held-out evaluation map list")
    return p.parse_args(argv)


def make_env_fns(ns, cfg, n, base_seed, seed_stride=1000, first=0):
    """The `n` env constructors of a pool, env i the global env first + i,
    seeded with base_seed + (first + i) * seed_stride."""
    if ns.env_name in ("StarCraft2v2", "SMACv2"):
        from onpolicy_torch.envs.starcraft2.distributions import \
            parse_smacv2_distribution
        from onpolicy_torch.envs.starcraft2.smacv2_env import SMACv2Env
        dist = parse_smacv2_distribution(
            SimpleNamespace(units=ns.units, map_name=ns.map_name))
        # StarCraft2v2 = the reference's SMACv2_modified (agent-specific
        # state + per-agent dones); SMACv2 = the plain wrapper
        modified = ns.env_name == "StarCraft2v2"
        if cfg.use_obs_instead_of_state:
            v2_state = "concat"
        else:
            v2_state = "agent_feature" if modified else "env"

        def fn(rank):
            return lambda: SMACv2Env(ns.map_name, dist,
                                     seed=base_seed + rank * seed_stride,
                                     state_type=v2_state,
                                     per_agent_dones=modified)
    else:
        from onpolicy_torch.envs.starcraft2.smac_env import SMACEnv
        # use_obs_instead_of_state short-circuits both state families to
        # the concat-of-obs state (StarCraft2_Env.py:1156-1158,1352-1354)
        if cfg.use_obs_instead_of_state:
            state_type = "concat"
        else:
            state_type = "agent_feature" if ns.use_state_agent else "env"
        state_options = {
            k: bool(getattr(ns, k)) for k in (
                "add_center_xy", "use_mustalive", "add_move_state",
                "add_local_obs", "add_distance_state", "add_xy_state",
                "add_visible_state", "add_enemy_action_state",
                "add_agent_id")}

        def fn(rank):
            return lambda: SMACEnv(ns.map_name,
                                   seed=base_seed + rank * seed_stride,
                                   state_type=state_type,
                                   state_options=state_options)
    if cfg.use_stacked_frames:
        from onpolicy_torch.envs.wrappers import StackedFrames
        inner = fn

        def fn(rank):
            thunk = inner(rank)
            return lambda: StackedFrames(thunk(), cfg.stacked_frames)
    return [fn(first + i) for i in range(n)]


def config_from_args(argv):
    """→ (parsed flags, Config): the env name StarCraft2 unless one of
    the SMAC names is given, num_agents from the map or from `--units`."""
    ns = parse_args(argv)
    overrides = {k: v for k, v in vars(ns).items()
                 if k in Config.__dataclass_fields__}
    if ns.env_name not in ("StarCraft2", "StarCraft2v2", "SMAC", "SMACv2"):
        overrides["env_name"] = "StarCraft2"
    if ns.env_name in ("StarCraft2v2", "SMACv2"):
        overrides["num_agents"] = int(ns.units.split("v")[0])
    else:
        overrides["num_agents"] = get_map_params(ns.map_name)["n_agents"]
    overrides["scenario_name"] = ns.map_name
    return ns, canonicalize_algorithm(
        apply_wandb_sweep(Config(**overrides))).validate()


def main(argv=None):
    ns, cfg = config_from_args(argv if argv is not None else sys.argv[1:])
    cfg = distributed.setup(cfg)
    writer = distributed.rank() == 0
    env_fns = make_env_fns(ns, cfg, cfg.n_rollout_threads, cfg.seed,
                           first=host_mesh.env_offset(cfg.n_rollout_threads))
    Pool = DummyVecEnv if cfg.n_rollout_threads == 1 else HostVecEnv
    envs = Pool(env_fns, protocol="share")
    eval_envs = None
    try:
        if cfg.use_eval and writer:
            # eval seeding: seed*50000 + rank*10000 (train_smac.py:80-99)
            eval_fns = make_env_fns(ns, cfg, cfg.n_eval_rollout_threads,
                                    cfg.seed * 50000, seed_stride=10000)
            EPool = DummyVecEnv if cfg.n_eval_rollout_threads == 1 \
                else HostVecEnv
            eval_envs = EPool(eval_fns, protocol="share")
        from onpolicy_torch.envs.starcraft2.smac_env import \
            smac_win_rate_metrics
        if cfg.algorithm_name in ("happo", "hatrpo"):
            from onpolicy_torch.runner.host_separated_runner import \
                HostSeparatedRunner as Runner
        else:
            from onpolicy_torch.runner.host_runner import \
                HostSharedRunner as Runner
        runner = Runner(cfg, envs, eval_env=eval_envs,
                        env_metrics=smac_win_rate_metrics())
        if not writer:
            return runner.run(log_fn=None)
        run_dir = make_run_dir(cfg)
        logger = MetricsLogger(run_dir, cfg)
        try:
            state, history = runner.run(log_fn=logger)
        finally:
            logger.close()
    finally:
        envs.close()
        if eval_envs is not None:
            eval_envs.close()
    return state, history


if __name__ == "__main__":
    main(sys.argv[1:])
    distributed.shutdown()
