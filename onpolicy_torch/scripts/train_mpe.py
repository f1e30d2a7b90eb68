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

The rest of the JAX package's MPE launch scripts: simple_reference
(`scripts/train_mpe_scripts/train_mpe_reference.sh`: shared rMAPPO,
MultiDiscrete (5, 10) actions), simple_speaker_listener through separated
policies (`train_mpe_comm.sh`) and HAPPO on simple_spread
(`scripts/train_other_algo/train_mpe_happo.sh`), e.g.

    python -m onpolicy_torch.scripts.train_mpe \
        --env_name MPE --algorithm_name rmappo --experiment_name check \
        --scenario_name simple_speaker_listener --num_agents 2 \
        --num_landmarks 3 --seed 1 --n_rollout_threads 128 \
        --num_mini_batch 1 --episode_length 25 --num_env_steps 2000000 \
        --ppo_epoch 15 --gain 0.01 --lr 7e-4 --critic_lr 7e-4 \
        --share_policy false

The JAX package's last two algorithms: MAT on simple_spread
(`scripts/train_other_algo/train_mpe_mat.sh`; `mpe_mat_dec` runs its
flags with `--algorithm_name mat_dec`) and HATRPO at HAPPO's spread
recipe:

    python -m onpolicy_torch.scripts.train_mpe --env_name MPE \
        --algorithm_name mat --experiment_name check \
        --scenario_name simple_spread --num_agents 3 --num_landmarks 3 \
        --seed 1 --n_rollout_threads 128 --episode_length 25 \
        --num_env_steps 20000000 --ppo_epoch 10 --lr 5e-4 \
        --n_block 1 --n_embd 64 --n_head 1

    python -m onpolicy_torch.scripts.train_mpe --env_name MPE \
        --algorithm_name hatrpo --scenario_name simple_spread \
        --num_agents 3 --num_landmarks 3 --seed 1 --n_rollout_threads 128 \
        --episode_length 25 --num_env_steps 3000000 --ppo_epoch 10 \
        --num_mini_batch 1 --lr 7e-4 --critic_lr 7e-4 --hidden_size 64

No launch script of the reference runs the other seven scenarios
(simple_adversary, simple_tag, simple_push, simple_crypto,
simple_crypto_display, simple_attack, simple_world_comm); `world_comm` is
the flagship's flags on the one with the most in it, through separated
policies (6 agents: a speaking leader with a MultiDiscrete (5, 4) head,
3 silent adversaries, 2 good agents; food, forests, per-agent rewards),
at the arguments of the JAX package's golden test of it:

    python -m onpolicy_torch.scripts.train_mpe --env_name MPE \
        --algorithm_name rmappo --scenario_name simple_world_comm \
        --num_agents 6 --num_landmarks 1 --num_good_agents 2 \
        --num_adversaries 4 --share_policy false --seed 1 \
        --n_rollout_threads 128 --episode_length 25 --ppo_epoch 10 \
        --num_mini_batch 1 --lr 7e-4 --critic_lr 7e-4 --hidden_size 64 \
        --use_ReLU false --gain 0.01 --num_env_steps 2000000

`share_policy false` (and happo and hatrpo, which imply it) trains
through `runner/separated_runner.py`, everything else (MAT included)
through `runner/shared_runner.py`; `--use_eval` adds an eval env of
`n_eval_rollout_threads` worlds. `CONFIGS` holds these ten as flag lists
(without a step count), for `chip_smoke.py`, `learning_check.py` and
`profile_episode.py`.

Data parallel over R processes, one card each (`parallel/distributed.py`;
`n_rollout_threads` stays the global count, each rank steps its 1/R):

    torchrun --standalone --nproc_per_node R \
        -m onpolicy_torch.scripts.train_mpe ... --mesh_shape R

and on the 2-D (data, model) mesh over D·M processes, each keeping its
blocks of the parameters and Adam moments along 'model' by the JAX
package's leaf rule (`parallel/mesh.py`); the rows split over all D·M
ranks, so `n_rollout_threads` (and each minibatch) must split over D·M:

    torchrun --standalone --nproc_per_node 4 \
        -m onpolicy_torch.scripts.train_mpe ... --mesh_shape 2,2

Ranks that share a card run `--dist_backend gloo` (NCCL refuses two
ranks on one GPU). Rank 0 logs, evaluates and writes the checkpoints,
which hold the whole state whatever the mesh.
"""
from __future__ import annotations

import sys

from onpolicy_torch.config import config_from_args
from onpolicy_torch.parallel import distributed
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
    # scripts/train_other_algo/train_mpe_happo.sh
    "happo_spread": _SPREAD + ["--algorithm_name", "happo",
                               "--n_rollout_threads", "128"],
}
_TWO_AGENTS = ["--env_name", "MPE", "--algorithm_name", "rmappo",
               "--num_agents", "2", "--num_landmarks", "3", "--seed", "1",
               "--n_rollout_threads", "128", "--num_mini_batch", "1",
               "--episode_length", "25", "--ppo_epoch", "15", "--gain",
               "0.01", "--lr", "7e-4", "--critic_lr", "7e-4"]
# scripts/train_mpe_scripts/train_mpe_reference.sh
CONFIGS["reference"] = _TWO_AGENTS + ["--scenario_name", "simple_reference"]
# scripts/train_mpe_scripts/train_mpe_comm.sh
CONFIGS["comm"] = _TWO_AGENTS + ["--scenario_name", "simple_speaker_listener",
                                 "--share_policy", "false"]
# scripts/train_other_algo/train_mpe_mat.sh, flag for flag (it sets no
# critic_lr or hidden_size: MAT has one optimizer and its width is n_embd)
CONFIGS["mpe_mat"] = ["--env_name", "MPE", "--algorithm_name", "mat",
                      "--scenario_name", "simple_spread", "--num_agents", "3",
                      "--num_landmarks", "3", "--seed", "1",
                      "--n_rollout_threads", "128", "--episode_length", "25",
                      "--ppo_epoch", "10", "--lr", "5e-4", "--n_block", "1",
                      "--n_embd", "64", "--n_head", "1"]
# the same flags for MAT-dec (its own script, train_mat_dec.sh, is SMACv2's)
CONFIGS["mpe_mat_dec"] = [
    "mat_dec" if f == "mat" else f for f in CONFIGS["mpe_mat"]]
# HATRPO on simple_spread at the recipe of RESULTS.md:92-93, the twin of
# happo_spread
CONFIGS["hatrpo_spread"] = _SPREAD + ["--algorithm_name", "hatrpo",
                                      "--n_rollout_threads", "128"]
# the flagship's flags on simple_world_comm, separated policies (the later
# flags take the place of _SPREAD's)
CONFIGS["world_comm"] = CONFIGS["flagship"] + [
    "--scenario_name", "simple_world_comm", "--num_agents", "6",
    "--num_landmarks", "1", "--num_good_agents", "2",
    "--num_adversaries", "4", "--share_policy", "false"]


def make_runner(cfg):
    """The shared or the separated runner for `cfg`, with an eval env of
    `n_eval_rollout_threads` worlds (drawing from its own generator,
    seeded with cfg.seed + 1) under `use_eval`, on rank 0 only."""
    import torch

    from onpolicy_torch.envs.mpe import make_vec_env
    if cfg.share_policy:
        from onpolicy_torch.runner.shared_runner import SharedRunner as Runner
    else:
        from onpolicy_torch.runner.separated_runner import \
            SeparatedRunner as Runner
    eval_env = None
    if cfg.use_eval and distributed.rank() == 0:
        device = torch.device(cfg.device)
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        eval_env = make_vec_env(cfg, device, generator,
                                n_envs=cfg.n_eval_rollout_threads)
    return Runner(cfg, eval_env=eval_env)


def main(argv=None):
    """Train; → (final state, logged rows). Under torchrun it joins the
    process group first (`distributed.setup`); rank 0 alone makes the run
    directory, logs and saves."""
    cfg = distributed.setup(config_from_args(argv))
    if cfg.env_name != "MPE":
        raise NotImplementedError(
            f"env {cfg.env_name!r}: the port's MPE entry point takes MPE")
    runner = make_runner(cfg)
    if distributed.rank() != 0:
        return runner.run(log_fn=None)
    run_dir = make_run_dir(cfg)
    logger = MetricsLogger(run_dir, cfg)
    try:
        state, history = runner.run(log_fn=logger, save_dir=run_dir / "models")
    finally:
        logger.close()
    return state, history


if __name__ == "__main__":
    main(sys.argv[1:])
    distributed.shutdown()
