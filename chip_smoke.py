#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`onpolicy_torch`) on one GPU.

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which fails the run (non-zero exit) if it fails:
  1. card:    name and power limit (nvidia-smi); TF32 off for matmuls.
  2. build:   nvcc of onpolicy_torch/csrc/gru_seq.cu for sm_90a.
  3. kernels: the GRU kernels against their plain PyTorch versions on
              the card, with f32 and then with bf16 streams, at each of
              `SHAPES`: the flagship, bench, ragged (B=5 below one tile,
              B=37 and B=803 on 8-row tiles, B=5003 on 16-row tiles where
              blocks walk two), T=1, masked, T=25/B=384 (naive-recurrent)
              and H=16/32/48 shapes (tensor-core kernels, every (H, tile)
              instantiation), ragged, T=1 and masked shapes of the
              CUDA-core kernels at H=40, H=128/256 shapes, and the
              shapes of the JAX
              package's other MPE scripts: T=10 B=640 (simple_reference),
              T=10 B=320 (separated runner, per agent) and T=25 B=128
              (HAPPO's whole-episode log-probs, forward only); each line
              names the forward and backward variants, tiles and grids;
              dW bitwise repeatable at the flagship, bench, T=25 and
              H=128 shapes. Where the backward is `tensor_core_wide`
              (64 < H <= 512, H % 32 == 0: the H=128/256 shapes here, the
              H=512 ones below) its three pieces are also held against
              their plain pieces on the same inputs (gate GEMM, carry,
              dW GEMM with its reduction). The forward at those widths is
              `tensor_core_wide` too (one GEMM a time step); its outs are
              bitwise repeatable where the backward's dW is checked so.
              The CUDA-core backward and forward that read W from device
              memory (`cuda_core_global_w`), which no shape of the main
              paths takes any longer, run at H=128 through explicit plans
              (`cuda_core_bwd_plan`; `cuda_core_fwd_plan` at B=17,000,
              where 64-row tiles leave W no room in shared memory).
              Then recurrent_N=2 through the autograd path on the card
              against the CPU path, in each stream type. Then, in f32,
              the Hanabi width H=512 (`HANABI_SHAPES`: T=10 B=20,000 as
              train_hanabi_device.sh gives it, ragged B=37, T=1, all-ones
              masks; outs and dW bitwise repeatable) and recurrent_N=2
              at H=512. Then, in f32 at H=64, the host runners' shapes
              (`HOST_SHAPES`): T=10 B=2,560 (SMAC 3s5z rMAPPO), T=10
              B=80 and T=400 B=2 (SMACv2 HAPPO per agent, and its
              whole-episode log-probs), T=10 B=1,500 (GRF 3v1). Then
              a data-parallel rank's shapes of phase 6 (`DP_FLAGSHIP`
              T=10 B=480, `DP_SMAC` T=10 B=128; f32, H=64).
  4. times:   kernel, plain version and cuDNN's nn.GRU (yardstick only)
              at the flagship and bench shapes, with CUDA events (`ms`),
              in f32 and with bf16 streams (cuDNN then in bf16); the
              kernels' device time from torch.profiler beside them
              (`device_ms`, null where the profiler saw no device time);
              then the CUDA-core forward and the one the shape takes
              (tensor-core at H=64, wide at H=512) on the same inputs
              through explicit plans, each held against the plain
              version, then timed in turns (CUDA-core, new, new,
              CUDA-core); and the Hanabi shape T=10 B=20,000 H=512 in
              f32, with the backward's scratch; then at that shape the
              two forwards in turns, and the old CUDA-core backward and
              the wide one on the same inputs through explicit plans,
              each held against the plain version and timed in turns
              (old, wide, wide, old), with each wide kernel's device ms;
              then the SMAC shape T=10 B=2,560 H=64 in f32, and the
              data-parallel ranks' T=10 B=480 and B=128. Then the
              LayerNorm kernels (csrc/layer_norm.cu, built on first use)
              at `LN_SHAPES`, each held to its plain twin (y, the saved
              mean and rstd, dx; dscale and dbias to float64 sums) and
              timed beside its bytes bound, the twins, the decomposed
              form the port ran before them and `F.layer_norm`
              (yardstick only).
  5. train:   one episode at 8 rollout threads on the card against the
              CPU path from the same state (rMAPPO in f32, rMAPPO and
              MAPPO with the critic dedup in bf16 and in f32, HAPPO with
              3 agents in f32 through the separated runner, MAT and
              MAT-dec in f32 through the shared runner, HATRPO with 3
              agents in f32 through the separated runner; Hanabi-Small
              rMAPPO at H=128 on the device engine from the same decks,
              and MAPPO and rMAPPO at H=32 (6 games) on the C++ engine
              through the host seat loop from the same engine seed, each
              an untrained episode and a trained one, the GRU launches of
              the update asserted), rMAPPO with PopArt (in place of
              ValueNorm) and rMAPPO on simple_world_comm (6 agents
              through the separated runner): rollout, update metrics,
              and the parameters' change; then, at a small size, the
              Box, MultiBinary and mixed heads and the CNN base
              (Box((4, 10, 10)) observations) forward and gradients, and
              each of the seven scenarios ported last (and
              simple_world_comm with walls, action and comm noise)
              stepped 26 steps, card against CPU in f32;
              then the port's `scripts/train_mpe.main` or
              `scripts/train_hanabi.main` for each run of `TRAIN_RUNS`: the
              flagship rMAPPO for 10 episodes, the JAX package's two
              bench configurations at 16,384 rollout threads for 3
              episodes each (MAPPO with the critic dedup and rMAPPO, in
              bf16), simple_reference, simple_speaker_listener and HAPPO
              on simple_spread for 5 each, 3 flagship episodes with an
              eval after each, train_mpe_mat.sh (MAT, n_embd 64) and
              HATRPO on simple_spread (hidden 64) for 3 each, neither of
              which launches a GRU kernel (MAT has no GRU; HATRPO's runs
              as the plain scan, as the JAX package routes it),
              train_hanabi_device.sh (rMAPPO, Hanabi-Full,
              hidden 512x2, 1000 fleets, T=100) for 3 episodes, the JAX
              package's Hanabi bench configuration (feed-forward MAPPO,
              bf16) for 2, and train_hanabi_forward.sh (feed-forward
              MAPPO, the same width, on the C++ engine through the host
              seat loop) for 3, then `scripts/eval_hanabi.main` with
              eval_hanabi_forward.sh's flags on its checkpoint (8 games on
              the C++ engine), the flagship with PopArt for 3 and
              `world_comm` (the flagship's flags on simple_world_comm,
              separated policies) for 5. Each run's kernel launches are asserted
              (derived beside `TRAIN_RUNS`; an f32 run must launch the
              LayerNorm kernels both ways, and the `kernels` line's
              LayerNorm rows carry each run's and rank's counts), and
              the wide forward's step
              launches (T a forward) where it runs; every parameter on
              the card; every logged metric finite; env-steps/s printed
              for each. Last, `profile_episode.py --config
              hanabi_forward`, then `smac_3s5z` and `football_3v1` (over
              the stand-ins below), print each run's rollout and update
              ms, device idle share and launches an episode.
              The host-ingestion path runs over the engine stand-ins
              defined below (no StarCraft II, smac, smacv2 or gfootball
              exists on either machine), installed in sys.modules of this
              process: one episode (T=40) of `HostSharedRunner` rMAPPO on
              the SMAC 3s5z stand-in (8 threads) and one of
              `HostSeparatedRunner` HAPPO on the SMACv2 protoss 5v5 one
              (2 threads), card against CPU from the same state with the
              card's actions injected; then, among `TRAIN_RUNS`,
              `scripts/train_smac.main` on train_smac_3s5z.sh (2
              episodes; the eval at episode 0 cut to 8 episodes) and
              train_happo.sh (SMACv2 HAPPO, 2 episodes, the same cut), and
              `scripts/train_football.main` on train_football_3v1.sh (50
              threads, 2 episodes), each over worker processes
              (`envs/host_vec.HostVecEnv`).
  6. data parallel (`data_parallel_phase`): ranks under `python -m
              torch.distributed.run --standalone` (torchrun), each
              running `scripts/<script>.main` through this script's
              `--dp-rank` mode, which counts its kernel launches from
              0 and records its parameters. (a) train_mpe's flagship
              for 2 episodes on 2 ranks (64 threads a rank) sharing the
              card on gloo (`--mesh_shape 2 --dist_backend gloo`)
              against one process without torchrun: parameters and the
              checkpoint rank 0 wrote within 2e-4 of their norm, its
              carry the global one, the logged metrics at rtol 2e-4 /
              atol 2e-5, the ranks' parameters bit for bit alike, 20
              launches of each kernel a rank an episode at T=10 B=480;
              (b) the same on 1 rank of NCCL under torchrun, bitwise
              equal to the run without it; (c) train_smac on
              train_smac_3s5z.sh over the stand-ins at T=40, 2 ranks x
              4 envs against one process x 8, as (a), 10 launches a
              rank an episode at T=10 B=128.
  7. render (`render_phase`): whether matplotlib and imageio import
              (the card's machine may lack both); `scripts/render_mpe`'s
              episode loop on the flagship's policy (2 episodes of 25
              steps) and `scripts/render_football`'s over the GRF
              stand-in (1 episode), each from one checkpoint restored on
              the card and on the CPU: the same actions, the rewards
              within 1e-5 relative, no GRU kernel launched, ms an episode
              on the card; frames (26 an episode) and gifs, into a
              temporary directory, only where matplotlib and imageio
              import.
The last three lines are one JSON object with a row per kernel and
stream type (and shape: flagship, bench, Hanabi, SMAC, and a
data-parallel rank's two), the card's name and power limit, and the
result line `{"ok": true, "device": {...}}`.
Exits non-zero with no result line when no CUDA device is present or
the port's package is not beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 non-tensor-core
# flop/s, dense TF32 tensor-core flop/s
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
TF32_FLOP_S = 495e12

FLAGSHIP = dict(T=10, B=960, H=64)       # 25*128*3/10 chunks of L=10
BENCH = dict(T=10, B=122880, H=64)       # 16384 rollout threads
HANABI = dict(T=10, B=20000, H=512)      # 100*1000*2/10 chunks of L=10
SMAC = dict(T=10, B=2560, H=64)          # 8 threads*400 steps*8 agents/10
# phase 6's ranks: the flagship's 960 chunks over 2 ranks (the meshes (2,)
# and (1, 2)) and over 4 (the mesh (2, 2)), the flagship at hidden 512
# over 2 (the mesh (1, 2), the wide kernels), and the 3s5z stand-in's 8
# threads*40 steps*8 agents/10 = 256 chunks over 2
DP_FLAGSHIP = dict(T=10, B=480, H=64)
DP22_FLAGSHIP = dict(T=10, B=240, H=64)
DP_WIDE = dict(T=10, B=480, H=512)
DP_SMAC = dict(T=10, B=128, H=64)
# (name, script, config of its CONFIGS, extra flags, episodes, forward and
# backward launches an episode). One PPO update of a recurrent policy
# launches each kernel once for the actor and once for the critic
# (recurrent_N 1, one minibatch), ppo_epoch times per trainer:
#   flagship, bench_rmappo: 10 epochs x 2                      = 20, 20
#   reference (shared, 15 epochs): 15 x 2                      = 30, 30
#   comm (separated, 2 agents, 15 epochs): 2 x 15 x 2          = 60, 60
#   happo_spread (3 agents, 10 epochs): 3 x 10 x 2 = 60, plus per agent
#     two forward-only evaluate_full_logp (before and after its update)
#                                                              = 66, 60
#   eval: the rollout step's GRU cell is plain torch           = +0
#   bench_mappo: feed-forward                                  = 0, 0
#   hanabi_device (15 epochs), a trained episode: 15 x 2       = 30, 30
#     its first episode only collects (training is deferred one
#     episode): 3 episodes launch 2 x 30 = 60 of each
#   bench_hanabi_width: feed-forward                           = 0, 0
#   mpe_mat: the transformer has no GRU                        = 0, 0
#   hatrpo_spread: its Fisher-vector product differentiates the GRU
#     twice, which the kernels cannot, so its GRU is the plain scan, as
#     the JAX package routes it (models/gru.py)                = 0, 0
#   hanabi_forward: feed-forward                               = 0, 0
#   flagship+popart: the flagship with PopArt in place of
#     ValueNorm; the GRU shapes are the flagship's           = 20, 20
#   world_comm (separated, 6 agents, 10 epochs, rMAPPO, so no
#     whole-episode log-probs): 6 x 10 x 2, at T=10 B=320 per agent
#                                                              = 120, 120
# and the host runners over worker processes and the engine stand-ins
# (every episode trains; the rollout's cell, the bootstrap and the eval
# are plain torch):
#   smac_3s5z (rMAPPO, 5 epochs, 1 minibatch, T=10 B=2,560): 5 x 2 = 10, 10
#   smacv2_happo (5 agents, 5 epochs, T=10 B=80 per agent): 5 x 5 x 2
#     = 50, plus per agent two forward-only whole-episode log-probs
#     (T=400 B=2), before and after its update                 = 60, 50
#   football_3v1 (rMAPPO, 15 epochs, 2 minibatches of B=1,500):
#     15 x 2 x 2                                                = 60, 60
TRAIN_RUNS = (("flagship", "train_mpe", "flagship", (), 10, 20, 20),
              ("bench_mappo", "train_mpe", "bench_mappo", (), 3, 0, 0),
              ("bench_rmappo", "train_mpe", "bench_rmappo", (), 3, 20, 20),
              ("reference", "train_mpe", "reference", (), 5, 30, 30),
              ("comm", "train_mpe", "comm", (), 5, 60, 60),
              ("happo_spread", "train_mpe", "happo_spread", (), 5, 66, 60),
              ("flagship+eval", "train_mpe", "flagship",
               ("--use_eval", "--eval_interval", "1"), 3, 20, 20),
              ("hanabi_device", "train_hanabi", "hanabi_device", (), 3, 30, 30),
              ("bench_hanabi_width", "train_hanabi", "bench_hanabi_width", (),
               2, 0, 0),
              ("mpe_mat", "train_mpe", "mpe_mat", (), 3, 0, 0),
              ("hatrpo_spread", "train_mpe", "hatrpo_spread", (), 3, 0, 0),
              ("hanabi_forward", "train_hanabi", "hanabi_forward", (), 3, 0,
               0),
              ("flagship+popart", "train_mpe", "flagship",
               ("--use_popart", "--use_valuenorm", "false"), 3, 20, 20),
              ("world_comm", "train_mpe", "world_comm", (), 5, 120, 120),
              # the eval at episode 0 cut to 8 episodes (the scripts: 32)
              ("smac_3s5z", "train_smac", "smac_3s5z",
               ("--eval_episodes", "8"), 2, 10, 10),
              ("smacv2_happo", "train_smac", "smacv2_happo",
               ("--eval_episodes", "8"), 2, 60, 50),
              ("football_3v1", "train_football", "football_3v1", (), 2, 60,
               60))
HOST_SCRIPTS = ("train_smac", "train_football")
# the GRU shapes (H=64 but for Hanabi's 512) at which each run of
# `TRAIN_RUNS` launches the kernels, beside its launches in a `kernels`
# row's `launches_by_run`: a row's times are at its own `shape`, so only
# the launches at that shape multiply them
_PER_AGENT = "T=10 B=320 per agent"
RUN_GRU_SHAPES = {
    "flagship": "T=10 B=960", "bench_rmappo": "T=10 B=122880",
    "reference": "T=10 B=640", "comm": _PER_AGENT,
    "happo_spread": _PER_AGENT + " (fwd 60, bwd 60 an episode); T=25 "
                    "B=128 (fwd 6 an episode)",
    "flagship+eval": "T=10 B=960", "hanabi_device": "T=10 B=20000 H=512",
    "flagship+popart": "T=10 B=960", "world_comm": _PER_AGENT,
    "smac_3s5z": "T=10 B=2560",
    "smacv2_happo": "T=10 B=80 per agent (fwd 50, bwd 50 an episode); "
                    "T=400 B=2 (fwd 10 an episode)",
    "football_3v1": "T=10 B=1500"}
# the same for phase 6's runs, by rank: (run, ranks, GRU shape)
DP_RUNS = (("dp flagship", 2, "T=10 B=480"),
           ("dp smac_3s5z", 2, "T=10 B=128"),
           ("dp 1,2 flagship", 2, "T=10 B=480"),
           ("dp 2,2 flagship", 4, "T=10 B=240"),
           ("dp 1,2 flagship H=512", 2, "T=10 B=480 H=512"),
           ("dp 1,2 smac_3s5z", 2, "T=10 B=128"))
DP_GRU_SHAPES = {f"{run} rank {r}": shape for run, ranks, shape in DP_RUNS
                 for r in range(ranks)}
# phase 5's scenario checks: (case, scenario, num_agents, num_landmarks,
# num_good_agents, num_adversaries, walls and noise), the arguments of the
# JAX package's golden test of each scenario (simple_attack: 2 + 2 agents
# on 4 landmarks); the last case adds two walls, action noise and comm
# noise to simple_world_comm
SCENARIO_CHECKS = (
    ("simple_adversary", "simple_adversary", 3, 2, 1, 3, False),
    ("simple_tag", "simple_tag", 4, 2, 1, 3, False),
    ("simple_push", "simple_push", 2, 2, 1, 3, False),
    ("simple_crypto", "simple_crypto", 3, 2, 1, 3, False),
    ("simple_crypto_display", "simple_crypto_display", 3, 2, 1, 3, False),
    ("simple_attack", "simple_attack", 4, 4, 2, 2, False),
    ("simple_world_comm", "simple_world_comm", 6, 1, 2, 4, False),
    ("world_comm walls+noise", "simple_world_comm", 6, 1, 2, 4, True))
# the flags of phase 5's world_comm card-vs-CPU episode
WORLD_COMM = dict(scenario_name="simple_world_comm", num_agents=6,
                  num_landmarks=1, num_good_agents=2, num_adversaries=4,
                  share_policy=False)
# phase 5's card-vs-CPU Hanabi runs (2 agents): Hanabi-Small rMAPPO on the
# device engine at 8 fleets, T=20, hidden 128, so that the CUDA-core
# kernels carry its update (T=10, B=32, H=128); and on the C++ engine
# through the host seat loop at 6 games, T=20, hidden 32, the algorithm
# given with it
_SMALL_CHECK = ["--hanabi_name", "Hanabi-Small", "--num_agents", "2",
                "--episode_length", "20", "--ppo_epoch", "2"]
HANABI_DEVICE_CHECK = _SMALL_CHECK + [
    "--algorithm_name", "rmappo", "--n_rollout_threads", "8",
    "--num_env_steps", "320", "--hidden_size", "128", "--use_jax_env",
    "--use_scan_rounds"]
HANABI_HOST_CHECK = _SMALL_CHECK + [
    "--n_rollout_threads", "6", "--num_env_steps", "240", "--hidden_size",
    "32"]
# phase 3's layer shapes, each run with f32 and with bf16 streams:
# (case, T, B, H, options of check_layer)
SHAPES = (
    ("flagship", *FLAGSHIP.values(), dict(repeat=True)),
    ("bench (16384 threads)", *BENCH.values(), dict(bench_scale=True)),
    ("B=37 (ragged 8-row tiles)", 10, 37, 64, {}),
    ("B=5 (below one tile)", 10, 5, 64, {}),
    ("B=803 (8k+3 rows)", 10, 803, 64, {}),
    ("B=5003 (ragged 16-row, 2 tiles)", 10, 5003, 64, {}),
    ("T=1", 1, 960, 64, {}),
    ("all-ones masks", 10, 960, 64, dict(mask_mode="ones")),
    ("T=25 B=384 (naive-recurrent)", 25, 384, 64, dict(repeat=True)),
    ("T=10 B=640 (simple_reference)", 10, 640, 64, {}),
    ("T=10 B=320 (separated, per agent)", 10, 320, 64, {}),
    ("T=25 B=128 (HAPPO episode log-probs)", 25, 128, 64, {}),
    ("H=48 (tensor core, 8-row tiles)", 10, 960, 48, {}),
    ("H=48 (tensor core, 16-row tiles)", 4, 2200, 48, {}),
    ("H=32 (tensor core, 16-row tiles)", 4, 2200, 32, {}),
    ("H=32 (tensor core, 8-row tiles)", 4, 300, 32, {}),
    ("H=16 (tensor core, 8-row tiles)", 4, 300, 16, {}),
    ("H=16 (tensor core, 16-row tiles)", 4, 2200, 16, {}),
    ("H=40 (CUDA-core kernels)", 10, 960, 40, {}),
    ("H=40 B=37 (ragged single tile)", 10, 37, 40, {}),
    ("H=40 T=1", 1, 300, 40, {}),
    ("H=40 all-ones masks", 10, 803, 40, dict(mask_mode="ones")),
    ("H=256 (weights in L2)", 10, 960, 256, {}),
    ("H=128 (backward weights in L2)", 5, 333, 128, dict(repeat=True)),
    ("H=128 T=1 all-ones", 1, 37, 128, dict(mask_mode="ones")),
    ("H=128 CUDA-core bwd (W in memory)", 10, 803, 128,
     dict(repeat=True, cuda_core_bwd=True)),
    ("H=128 CUDA-core fwd (W in memory)", 2, 17000, 128,
     dict(cuda_core_fwd=True)),
)
# Hanabi width, f32 streams only (train_hanabi_device.sh trains in f32;
# the Hanabi bench configuration is feed-forward): W (3.15 MB) fits no
# block's shared memory, so the wide forward and backward stream it from
# L2 in chunks
HANABI_SHAPES = (
    ("Hanabi T=10 B=20000 H=512", *HANABI.values(), dict(bench_scale=True)),
    ("H=512 B=37 (ragged single tile)", 10, 37, 512, {}),
    ("H=512 T=1", 1, 20000, 512, {}),
    ("H=512 all-ones masks", 10, 803, 512, dict(mask_mode="ones")),
)


# ---------------------------------------------------------------------------
# engine stand-ins: neither machine has StarCraft II, smac, smacv2 or
# gfootball. These take the place of the simulators only, with the
# published sizes, behind the port's real adapters (envs/starcraft2/
# smac_env.py, smacv2_env.py, envs/football/football_env.py) and feature
# builders. Module-level classes, so that a forked or spawned pool worker
# finds them; `install_engine_standins` puts them in sys.modules (this
# process only; the tests do it under monkeypatch).
# ---------------------------------------------------------------------------

class StandInUnit:
    """One unit as the engines' attribute surface shows it."""

    def __init__(self, kind, x, y, health, shield, cooldown):
        self.kind = kind
        self.pos = _Point(x, y)
        self.health = self.health_max = float(health)
        self.shield = self.shield_max = float(shield)
        self.unit_type = kind
        self.energy = 0.0
        self.weapon_cooldown = 0.0
        self.max_cooldown = float(cooldown)


class _Point:
    def __init__(self, x, y):
        self.x, self.y = float(x), float(y)


class StandInBattle:
    """A seeded skirmish of n_agents allies against n_enemies enemies on a
    map_x x map_y map, with SMAC's action layout (0 no-op, 1 stop, 2-5
    move north/south/east/west, 6 + e attack enemy e) and SMAC's step
    contract: (reward, terminated, info) with info["battle_won"] and
    info["episode_limit"]. Enemies walk to the nearest ally and fire in
    range; the damage each side deals a hit is drawn per episode, so that
    some battles are won, some lost and some run into the episode limit.
    Shot range 6, sight range 9, move 2 (SMAC's)."""

    # health, shield, max weapon cooldown (SMAC's Protoss units)
    UNITS = {"stalker": (80, 80, 35.0), "zealot": (100, 50, 22.0),
             "colossus": (200, 150, 24.0), "marine": (45, 0, 15.0)}
    SHOOT, SIGHT, MOVE = 6.0, 9.0, 2.0

    def __init__(self, n_agents, n_enemies, episode_limit, kinds, seed,
                 map_x=32, map_y=32):
        import numpy as np
        self.np = np
        self.rng = np.random.default_rng(seed)
        self.n_agents, self.n_enemies = n_agents, n_enemies
        self.n_actions = 6 + n_enemies
        self.episode_limit = episode_limit
        self.kinds = kinds                       # type ids in this order
        self.map_x = self.map_y = None
        self._map = (float(map_x), float(map_y))
        self.max_distance_x, self.max_distance_y = self._map
        self.unit_type_bits = len(kinds) if len(kinds) > 1 else 0
        shields = any(self.UNITS[k][1] > 0 for k in kinds)
        self.shield_bits_ally = self.shield_bits_enemy = int(shields)
        self.obs_all_health = self.obs_own_health = True
        self.state_last_action = True
        self.map_type = "stalkers_and_zealots"
        self.medivac_id = -1
        self.battles_won = self.battles_game = self.timeouts = 0
        self.force_restarts = 0
        self.win_counted = False
        self._episode_steps = 0
        self.agents, self.enemies = {}, {}
        self.death_tracker_ally = np.zeros(n_agents)
        self.last_action = np.zeros((n_agents, self.n_actions), np.float32)

    # ---- layout of a new battle (overridden by the SMACv2 stand-in) -----
    def _teams(self):
        n = len(self.kinds)
        ally = [self.kinds[min(i * n // self.n_agents, n - 1)]
                for i in range(self.n_agents)]
        enemy = [self.kinds[min(e * n // self.n_enemies, n - 1)]
                 for e in range(self.n_enemies)]
        return ally, enemy

    def _positions(self):
        cx, cy = self._map[0] / 2, self._map[1] / 2
        r = self.rng
        ally = [(cx - 4 + r.uniform(-2, 2), cy + r.uniform(-4, 4))
                for _ in range(self.n_agents)]
        enemy = [(cx + 4 + r.uniform(-2, 2), cy + r.uniform(-4, 4))
                 for _ in range(self.n_enemies)]
        return ally, enemy

    def reset(self):
        np = self.np
        self.map_x, self.map_y = self._map      # known once launched
        ally_kinds, enemy_kinds = self._teams()
        ally_pos, enemy_pos = self._positions()
        make = lambda k, p: StandInUnit(k, p[0], p[1], *self.UNITS[k])
        self.agents = {i: make(k, p) for i, (k, p) in
                       enumerate(zip(ally_kinds, ally_pos))}
        self.enemies = {e: make(k, p) for e, (k, p) in
                        enumerate(zip(enemy_kinds, enemy_pos))}
        for u in list(self.agents.values()) + list(self.enemies.values()):
            u.weapon_cooldown = float(self.rng.uniform(0, u.max_cooldown))
        # the damage of a hit on each side, drawn per battle
        self.ally_hit = float(self.rng.uniform(3.0, 12.0))
        self.enemy_hit = float(self.rng.uniform(1.0, 6.0))
        self.enemy_fire = float(self.rng.uniform(0.1, 0.4))
        self.death_tracker_ally = np.zeros(self.n_agents)
        self.last_action = np.zeros((self.n_agents, self.n_actions),
                                    np.float32)
        self._episode_steps = 0
        self.win_counted = False
        return None

    # ---- the attribute surface the feature builders read ---------------
    def get_unit_by_id(self, i):
        return self.agents[i]

    def unit_sight_range(self, i):
        return self.SIGHT

    def unit_max_cooldown(self, u):
        return u.max_cooldown

    def unit_max_shield(self, u):
        return u.shield_max or None

    def get_unit_type_id(self, u, ally):
        return self.kinds.index(u.kind)

    @staticmethod
    def _dist(a, b):
        return ((a.pos.x - b.pos.x) ** 2 + (a.pos.y - b.pos.y) ** 2) ** 0.5

    def get_avail_agent_actions(self, i):
        u = self.agents[i]
        avail = [0] * self.n_actions
        if u.health <= 0:
            avail[0] = 1
            return avail
        avail[1] = 1
        x, y, m = u.pos.x, u.pos.y, self.MOVE
        avail[2] = int(y + m < self.map_y)
        avail[3] = int(y - m > 0)
        avail[4] = int(x + m < self.map_x)
        avail[5] = int(x - m > 0)
        for e, t in self.enemies.items():
            if t.health > 0 and self._dist(u, t) <= self.SHOOT:
                avail[6 + e] = 1
        return avail

    def get_avail_actions(self):
        return [self.get_avail_agent_actions(i) for i in range(self.n_agents)]

    def get_state(self):
        np = self.np
        rows = [[u.health / u.health_max, u.shield / max(u.shield_max, 1),
                 u.pos.x / self._map[0], u.pos.y / self._map[1]]
                for u in list(self.agents.values())
                + list(self.enemies.values())]
        return np.concatenate([np.asarray(rows, np.float32).ravel(),
                               self.last_action.ravel()])

    def _hit(self, target, damage):
        """Damage to the shield first, then to health; → damage dealt."""
        dealt = 0.0
        if target.shield > 0:
            s = min(target.shield, damage)
            target.shield -= s
            damage -= s
            dealt += s
        h = min(target.health, damage)
        target.health -= h
        return dealt + h

    def step(self, actions):
        np = self.np
        actions = [int(a) for a in actions]
        self._episode_steps += 1
        self.last_action = np.eye(self.n_actions,
                                  dtype=np.float32)[actions]
        dealt, kills = 0.0, 0
        for i, a in enumerate(actions):
            u = self.agents[i]
            if u.health <= 0:
                continue
            if 2 <= a <= 5:
                dx, dy = ((0, 1), (0, -1), (1, 0), (-1, 0))[a - 2]
                u.pos.x += dx * self.MOVE
                u.pos.y += dy * self.MOVE
            elif a >= 6:
                t = self.enemies[a - 6]
                if t.health > 0:
                    dealt += self._hit(t, self.ally_hit
                                       * self.rng.uniform(0.5, 1.5))
                    kills += int(t.health <= 0)
                    u.weapon_cooldown = u.max_cooldown
            u.weapon_cooldown = max(0.0, u.weapon_cooldown - 1.0)
        alive = [u for u in self.agents.values() if u.health > 0]
        for t in self.enemies.values():
            if t.health <= 0 or not alive:
                continue
            near = min(alive, key=lambda u: self._dist(u, t))
            d = self._dist(near, t)
            if d > self.SHOOT - 1:
                step = min(self.MOVE, d - (self.SHOOT - 1)) / d
                t.pos.x += (near.pos.x - t.pos.x) * step
                t.pos.y += (near.pos.y - t.pos.y) * step
            elif self.rng.uniform() < self.enemy_fire:
                self._hit(near, self.enemy_hit * self.rng.uniform(0.5, 1.5))
        for i, u in self.agents.items():
            if u.health <= 0:
                self.death_tracker_ally[i] = 1
        won = all(t.health <= 0 for t in self.enemies.values())
        lost = all(u.health <= 0 for u in self.agents.values())
        enemy_total = sum(t.health_max + t.shield_max
                          for t in self.enemies.values())
        max_reward = self.n_enemies * 10 + 200 + enemy_total
        reward = dealt + 10 * kills + (200 if won else 0)
        info = {}
        terminated = won or lost
        if terminated:
            self.battles_game += 1
            if won:
                self.battles_won += 1
                self.win_counted = True
            info["battle_won"] = won
        elif self._episode_steps >= self.episode_limit:
            terminated = True
            self.battles_game += 1
            self.timeouts += 1
            info["episode_limit"] = True
            info["battle_won"] = False
        return reward / (max_reward / 20.0), terminated, info

    def close(self):
        pass


class StandInStarCraft2Env(StandInBattle):
    """Stands in for `smac.env.StarCraft2Env` on SMAC's maps, at the
    sizes of `envs/starcraft2/smac_maps.py` (3s5z: 8 allies against 8
    enemies, 3 stalkers and 5 zealots a side, 14 actions, unit_type_bits
    2, Protoss shields, episode_limit 150)."""

    def __init__(self, map_name="3s5z", seed=None, obs_last_action=False,
                 **kwargs):
        from onpolicy_torch.envs.starcraft2.smac_maps import get_map_params
        p = get_map_params(map_name)
        kinds = (["stalker", "zealot"] if p["map_type"]
                 == "stalkers_and_zealots" else ["marine"])
        super().__init__(p["n_agents"], p["n_enemies"], p["limit"], kinds,
                         seed)
        self.map_type = p["map_type"]
        self._seed = seed
        self.reset()
        self.map_x = self.map_y = 0          # set again at the first reset

    def _teams(self):
        if self.kinds != ["stalker", "zealot"]:
            return super()._teams()
        stalkers = 3 * self.n_agents // 8
        ally = ["stalker"] * stalkers + ["zealot"] * (self.n_agents - stalkers)
        stalkers = 3 * self.n_enemies // 8
        enemy = ["stalker"] * stalkers + ["zealot"] * (self.n_enemies
                                                       - stalkers)
        return ally, enemy

    def get_obs(self):
        from onpolicy_torch.envs.starcraft2 import obs_builder as ob
        from onpolicy_torch.envs.starcraft2 import state_builder as sb
        return ob.all_obs(sb.config_from_smac(self),
                          sb.snapshot_from_smac(self))

    def get_env_info(self):
        from onpolicy_torch.envs.starcraft2 import obs_builder as ob
        from onpolicy_torch.envs.starcraft2 import state_builder as sb
        cfg = sb.config_from_smac(self)
        return {"n_agents": self.n_agents, "n_actions": self.n_actions,
                "episode_limit": self.episode_limit,
                "obs_shape": ob.obs_dim(cfg),
                "state_shape": len(self.get_state())}


class StandInCapabilityEngine(StandInBattle):
    """The engine inside the SMACv2 stand-in: teams and start positions
    drawn from the capability config through the port's
    `envs/starcraft2/distributions.py` (10gen_protoss: stalker, zealot,
    colossus at weights 0.45 / 0.45 / 0.1, unit_type_bits 3; surrounded
    or reflected starts on a 32 x 32 map), episode_limit 200, own
    positions observed (obs_own_pos), the v2 flags the builders read."""

    def __init__(self, capability_config, map_name, seed):
        from onpolicy_torch.envs.starcraft2 import distributions as dist
        cc = capability_config
        n, ne = cc["n_units"], cc["n_enemies"]
        team = cc["team_gen"]
        super().__init__(n, ne, 200, list(team["unit_types"]), seed)
        self.unit_type_bits = len(team["unit_types"])
        self.map_type = map_name.split("_")[-1] + "_gen"
        common = {"n_units": n, "n_enemies": ne}
        self._team_gen = dist.get_distribution(team["dist_type"])(
            {**team, **common, "env_key": "team_gen"}, self.rng)
        self._start_gen = dist.get_distribution(
            cc["start_positions"]["dist_type"])(
            {**cc["start_positions"], **common,
             "env_key": "start_positions"}, self.rng)
        self.obs_own_pos = True
        self.obs_last_action = False
        self.obs_timestep_number = False
        self.state_timestep_number = False
        self.replace_teammates = True
        self.reset()

    def _teams(self):
        t = self._team_gen.generate()["team_gen"]
        return t["ally_team"], t["enemy_team"]

    def _positions(self):
        s = self._start_gen.generate()
        clip = lambda p: (min(max(p[0], 0.5), self._map[0] - 0.5),
                          min(max(p[1], 0.5), self._map[1] - 0.5))
        return ([clip(p) for p in s["ally_start_positions"]["item"]],
                [clip(p) for p in s["enemy_start_positions"]["item"]])


class StandInCapabilityEnvWrapper:
    """Stands in for `smacv2.env.StarCraftCapabilityEnvWrapper`: `env` is
    the engine, whose observations come from the port's
    `envs/starcraft2/v2_builders.py` (the public smacv2 engine computes
    the same layout)."""

    def __init__(self, capability_config=None, map_name="10gen_protoss",
                 seed=None, **kwargs):
        self.env = StandInCapabilityEngine(capability_config, map_name, seed)

    def _cfg_snap(self):
        from onpolicy_torch.envs.starcraft2 import v2_builders as vb
        return vb, vb.config_from_smacv2(self.env), \
            vb.snapshot_from_smacv2(self.env)

    def get_env_info(self):
        vb, cfg, _ = self._cfg_snap()
        return {"n_agents": self.env.n_agents,
                "n_actions": self.env.n_actions,
                "episode_limit": self.env.episode_limit,
                "obs_shape": vb.obs_dim(cfg),
                "state_shape": len(self.env.get_state())}

    def get_obs(self):
        import numpy as np
        vb, cfg, snap = self._cfg_snap()
        return np.stack([vb.agent_obs(cfg, snap, i)
                         for i in range(self.env.n_agents)])

    def get_avail_actions(self):
        return self.env.get_avail_actions()

    def get_state(self):
        return self.env.get_state()

    def reset(self):
        return self.env.reset()

    def step(self, actions):
        return self.env.step(actions)

    def close(self):
        self.env.close()


class StandInFootballEnv:
    """Stands in for `gfootball.env.create_environment(...)` on
    academy_3_vs_1_with_keeper: 3 controlled left players (and a left
    keeper) against a defender and a keeper, simple115v2 observations
    (115 floats a player), 19 actions, game_duration 400. The ball
    carrier moves, passes (9-11) or shoots (12); a shot scores by its
    distance to goal, the defender takes the ball with a chance that
    grows as he closes in; the episode ends on a goal, a lost ball or the
    last step. Rewards "scoring,checkpoints": 1 a goal, 0.1 for each of
    ten zones nearer the goal that the carrier first enters."""

    N_ACTIONS, DURATION = 19, 400

    def __init__(self, n_players=3, seed=0, rewards="scoring,checkpoints"):
        import numpy as np
        self.np = np
        self.n = n_players
        self.rng = np.random.default_rng(seed)
        self.checkpoints = "checkpoints" in rewards
        self.observation_space = _GymBox((n_players, 115))
        self.action_space = _GymMultiDiscrete([self.N_ACTIONS] * n_players)
        self.unwrapped = self
        self._reset_state()

    def _reset_state(self):
        np = self.np
        r = self.rng
        # left: keeper, then the three attackers; right: keeper, defender
        self.left = np.array([[-1.0, 0.0]] + [[0.6 + r.uniform(-0.05, 0.05),
                                                y + r.uniform(-0.05, 0.05)]
                                               for y in (0.0, 0.2, -0.2)])
        self.right = np.array([[1.0, 0.0], [0.75, r.uniform(-0.05, 0.05)]])
        self.owner = 1 + int(r.integers(3))      # a left player has the ball
        self.steps_left = self.DURATION
        self.zones = 0
        self.sticky = np.zeros((self.n, 10), np.float32)

    def observation(self):
        np = self.np
        ball = self.left[self.owner]
        out = []
        for i in range(self.n):
            out.append({"steps_left": self.steps_left,
                        "active": 1 + i, "designated": self.owner,
                        "sticky_actions": self.sticky[i].copy(),
                        "ball": np.array([ball[0], ball[1], 0.0]),
                        "ball_owned_team": 0,
                        "score": [0, 0]})
        return out

    def _obs(self):
        np = self.np
        ball = self.left[self.owner]
        rows = []
        for i in range(self.n):
            left = np.zeros((11, 2)); left[:4] = self.left
            right = np.zeros((11, 2)); right[:2] = self.right
            active = np.zeros(11); active[1 + i] = 1
            mode = np.zeros(7); mode[0] = 1
            rows.append(np.concatenate([
                left.ravel(), np.zeros(22), right.ravel(), np.zeros(22),
                [ball[0], ball[1], 0.0], np.zeros(3), [0, 1, 0], active,
                mode]))
        return np.asarray(rows, np.float32)

    def reset(self):
        self._reset_state()
        return self._obs()

    def step(self, actions):
        np = self.np
        r = self.rng
        self.steps_left -= 1
        reward = np.zeros(self.n, np.float32)
        done, scored = False, 0
        moves = {1: (-1, 0), 2: (-1, 1), 3: (0, 1), 4: (1, 1), 5: (1, 0),
                 6: (1, -1), 7: (0, -1), 8: (-1, -1)}
        for i, a in enumerate(actions):
            p = 1 + i
            self.sticky[i] = 0
            if a in moves:
                self.sticky[i, a - 1 if a <= 8 else 0] = 1
                self.left[p] += 0.01 * np.asarray(moves[a], float)
                self.left[p] = np.clip(self.left[p], [-1, -0.42], [1, 0.42])
            elif p == self.owner and a in (9, 10, 11):
                self.owner = 1 + int(r.choice([j for j in range(self.n)
                                               if j != i]))
            elif p == self.owner and a == 12 and not done:
                dist = np.hypot(1.0 - self.left[p][0], self.left[p][1])
                if r.uniform() < max(0.0, 0.6 - dist):
                    scored, done = 1, True
                else:
                    done = True                  # the keeper holds it
        carrier = self.left[self.owner]
        d = self.right[1] - carrier
        self.right[1] -= 0.02 * d / max(np.hypot(*d), 1e-6)
        if not done and r.uniform() < 0.05 / max(np.hypot(*d), 0.1) ** 2 / 100:
            done = True                          # the defender wins the ball
        if self.checkpoints:
            zone = int(np.clip((np.hypot(1.0 - carrier[0], carrier[1])
                                ) * -10 + 10, 0, 10))
            if zone > self.zones and not scored:
                reward += 0.1 * (zone - self.zones)
                self.zones = zone
        if scored:
            reward += 1.0 + 0.1 * (10 - self.zones)
        if self.steps_left <= 0:
            done = True
        return self._obs(), reward, done, {"score_reward": scored}

    def seed(self, seed=None):
        self.rng = self.np.random.default_rng(seed)

    def render(self, mode="rgb_array"):
        return self.np.zeros((72, 96, 3), self.np.uint8)

    def close(self):
        pass


# gym's Box and MultiDiscrete as `spaces.from_gym` and the GRF adapter
# read them: by class name, with `shape` and `nvec`
_GymBox = type("Box", (), {"__init__": lambda self, shape: setattr(
    self, "shape", tuple(shape))})
_GymMultiDiscrete = type("MultiDiscrete", (), {
    "__init__": lambda self, nvec: setattr(self, "nvec", list(nvec))})


def standin_create_environment(env_name="academy_3_vs_1_with_keeper",
                               number_of_left_players_agent_controls=3,
                               rewards="scoring,checkpoints", **kwargs):
    """`gfootball.env.create_environment`'s stand-in (the adapter passes
    no seed, so every stand-in starts from seed 0, as every engine of a
    pool starts from its own default)."""
    return StandInFootballEnv(number_of_left_players_agent_controls,
                              rewards=rewards)


def engine_standin_modules() -> dict:
    """The module objects `smac`, `smac.env`, `smacv2`, `smacv2.env`,
    `gfootball` and `gfootball.env` with the stand-ins in them."""
    import types
    mods = {}
    for pkg, attr, obj in (
            ("smac", "StarCraft2Env", StandInStarCraft2Env),
            ("smacv2", "StarCraftCapabilityEnvWrapper",
             StandInCapabilityEnvWrapper),
            ("gfootball", "create_environment", standin_create_environment)):
        env = types.ModuleType(f"{pkg}.env")
        setattr(env, attr, obj)
        top = types.ModuleType(pkg)
        top.env = env
        mods[pkg], mods[f"{pkg}.env"] = top, env
    return mods


def install_engine_standins():
    sys.modules.update(engine_standin_modules())

# the host runners' GRU shapes, f32 streams, H=64: SMAC 3s5z rMAPPO's
# update, SMACv2 HAPPO's per-agent update and its whole-episode log-probs
# (forward and backward held), GRF 3v1's minibatch
HOST_SHAPES = (
    ("SMAC 3s5z T=10 B=2560", *SMAC.values(), dict(repeat=True)),
    ("SMACv2 HAPPO T=10 B=80 (per agent)", 10, 80, 64, {}),
    ("SMACv2 HAPPO T=400 B=2 (log-probs)", 400, 2, 64, {}),
    ("GRF 3v1 T=10 B=1500 (minibatch)", 10, 1500, 64, {}),
)
# phase 5's card-vs-CPU host episodes: rMAPPO on the SMAC stand-in (8
# threads, T=40, L=10) and HAPPO on the SMACv2 one (2 threads, T=40), f32
HOST_CHECKS = (
    ("host rmappo f32 (SMAC 3s5z stand-in, 8 threads)", "smac_3s5z"),
    ("host happo f32 (SMACv2 protoss 5v5 stand-in, 2 threads)",
     "smacv2_happo"))


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# inputs and comparisons
# ---------------------------------------------------------------------------

def make_inputs(torch, T, B, H, seed, mask_mode="sprinkled",
                stream_dtype=None):
    """Layer inputs on the card; gir, giz, gin and douts in `stream_dtype`
    (f32 when None)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    rn = lambda *s, scale=1.0: torch.randn(*s, generator=g, device=dev) * scale
    x = dict(gir=rn(T, B, H), giz=rn(T, B, H), gin=rn(T, B, H),
             h0=rn(B, H, scale=0.5), w_hh=rn(H, 3 * H, scale=H ** -0.5),
             b_hh=rn(3 * H, scale=0.1))
    if mask_mode == "ones":
        m = torch.ones(T, B, 1, device=dev)
    else:
        m = (torch.rand(T, B, 1, generator=g, device=dev) > 0.1).float()
        m[0] = 0.0                      # every row starts an episode at t=0
    x["masks"] = m
    x["douts"] = rn(T, B, H, scale=0.1)
    x["dhT"] = rn(B, H, scale=0.1)
    if stream_dtype is not None:
        for k in ("gir", "giz", "gin", "douts"):
            x[k] = x[k].to(stream_dtype)
    return x


def max_err(a, b, scale=1.0):
    return float((a.float() - b.float()).abs().max()) / scale


def assert_close(torch, name, a, b, rtol, atol, scale=1.0):
    a, b = a.float(), b.float()
    ok = torch.allclose(a / scale, b / scale, rtol=rtol, atol=atol)
    if not ok:
        raise AssertionError(
            f"{name}: max abs err {max_err(a, b, scale):.3e} "
            f"(scale {scale:.3g}, rtol {rtol}, atol {atol})")


# A bf16 stream written by the kernel and by the plain version from the
# same inputs holds the same f32 value up to summation order, rounded to
# bf16: the two may land on neighbouring bf16 values, one ulp (2^-7 of
# the value) apart. f32 results keep the f32 tolerances.
BF16_STREAM_TOL = (2 ** -7, 2e-5)


def check_layer(torch, cg, case, T, B, H, mask_mode="sprinkled",
                bench_scale=False, repeat=False, stream_dtype=None,
                cuda_core_bwd=False, cuda_core_fwd=False):
    """Kernel vs plain version for one layer; with `repeat` (or
    `bench_scale`) the forward and the backward also run twice and must
    give the same bits. `stream_dtype` bf16 moves gi, outs, douts and dgi
    in bf16. `cuda_core_bwd` / `cuda_core_fwd` run the CUDA-core backward
    (`cuda_core_bwd_plan`) / forward (`cuda_core_fwd_plan`, which must
    then read W from device memory) where the shape would take another.
    Returns (fwd_err, bwd_err)."""
    bf16 = stream_dtype is not None
    itemsize = 2 if bf16 else 4
    limits = cg.device_limits(torch.cuda.current_device())
    plan = cg.device_bwd_plan(torch.device("cuda"), B, H, itemsize, T)
    if cuda_core_bwd:
        plan = cg.cuda_core_bwd_plan(B, H, *limits)
    fplan = cg.device_fwd_plan(torch.device("cuda"), B, H, itemsize)
    if cuda_core_fwd:
        fplan = cg.cuda_core_fwd_plan(B, H, *limits)
        if fplan.variant != cg.GLOBAL_W:
            raise AssertionError(f"{case}: {fplan} keeps W in shared memory")
    x = make_inputs(torch, T, B, H, seed=T * 7919 + B * 31 + H,
                    mask_mode=mask_mode, stream_dtype=stream_dtype)
    args = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
            x["b_hh"])
    outs, hT = cg.gru_layer_fwd(*args, plan=fplan)
    r_outs, r_hT = cg.gru_layer_fwd_ref(*args)
    torch.cuda.synchronize()
    if outs.dtype != r_outs.dtype or outs.dtype != x["gir"].dtype:
        raise AssertionError(f"{case}: outs {outs.dtype}, plain "
                             f"{r_outs.dtype}, streams {x['gir'].dtype}")
    stream_tol = BF16_STREAM_TOL if bf16 else (1e-5, 1e-5)
    assert_close(torch, f"{case} outs", outs, r_outs, *stream_tol)
    assert_close(torch, f"{case} hT", hT, r_hT, 1e-5, 1e-5)
    fwd_err = max(max_err(outs, r_outs), max_err(hT, r_hT))
    if bench_scale or repeat:
        again = cg.gru_layer_fwd(*args, plan=fplan)
        torch.cuda.synchronize()
        if not (torch.equal(outs, again[0]) and torch.equal(hT, again[1])):
            raise AssertionError(f"{case}: forward not repeatable")
        del again

    bargs = (x["gir"], x["giz"], x["gin"], r_outs, x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"], x["b_hh"])
    got = cg.gru_layer_bwd(*bargs, plan=plan)
    ref = cg.gru_layer_bwd_ref(*bargs)
    torch.cuda.synchronize()
    names = ("dgir", "dgiz", "dgin", "dh0", "dw_hh", "db_hh")
    bwd_errs = check_bwd_outputs(torch, case, got, ref, bf16, bench_scale)
    bwd_err = max(bwd_errs.values())
    worst = max(bwd_errs, key=bwd_errs.get)
    if bench_scale or repeat:
        again = cg.gru_layer_bwd(*bargs, plan=plan)
        torch.cuda.synchronize()
        for n, a, b in zip(names, got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"{case} {n}: backward not deterministic")
    if plan.variant == cg.WIDE:
        bwd_err = max(bwd_err, check_wide_pieces(torch, cg, case, x, r_outs,
                                                 bf16, bench_scale))
    log(f"  {case:<34} {'bf16' if bf16 else 'f32 '} T={T:<3} B={B:<7} H={H:<4} "
        f"fwd {fplan.name:<18} (tile {fplan.bt}, {fplan.grid} blocks)  "
        f"bwd {plan.name:<18} (tile {plan.bt}, {plan.grid} blocks)  "
        f"fwd err {fwd_err:.2e}  bwd err {bwd_err:.2e} (whole: {worst} "
        f"{bwd_errs[worst]:.2e})  ok")
    return fwd_err, bwd_err


def check_bwd_outputs(torch, case, got, ref, bf16, bench_scale):
    """The backward's six outputs against the plain version's: dgi within
    one bf16 ulp with bf16 streams, the rest at rtol 2e-4 / atol 2e-5;
    with `bench_scale` dW and db relative to their largest entry (a sum
    of T*B products per entry reorders between the two versions).
    Returns {output: max err}."""
    errs = {}
    for n, a, b in zip(("dgir", "dgiz", "dgin", "dh0", "dw_hh", "db_hh"),
                       got, ref):
        scale = max(1.0, float(b.abs().max())) \
            if (bench_scale and n in ("dw_hh", "db_hh")) else 1.0
        tol = BF16_STREAM_TOL if (bf16 and n.startswith("dgi")) \
            else (2e-4, 2e-5)
        assert_close(torch, f"{case} {n}", a, b, *tol, scale)
        errs[n] = max_err(a, b, scale)
    return errs


def check_wide_pieces(torch, cg, case, x, outs, bf16, bench_scale):
    """The wide backward's three pieces against their plain pieces, each
    on the same inputs: GH at the forward's tolerance (1e-5); the carry,
    given the plain GH, its dgi (one bf16 ulp with bf16 streams), dh0 and
    dG at the gradients' (2e-4 / 2e-5); the dW GEMM with its reduction,
    given the plain dG, at the gradients', relative to the largest entry
    at the bench scale. Returns the largest error."""
    hprev0 = x["h0"].to(outs.dtype)
    common = (outs, hprev0, x["masks"])
    gh = cg.gru_bwd_gates(*common, x["w_hh"], x["b_hh"])
    gh_ref = cg.gru_bwd_gates_ref(*common, x["w_hh"], x["b_hh"])
    cargs = (x["gir"], x["giz"], x["gin"], outs, hprev0, x["masks"],
             x["douts"], x["dhT"], x["w_hh"])
    carry = cg.gru_bwd_carry(*cargs, gh_ref.clone())
    carry_ref = cg.gru_bwd_carry_ref(*cargs, gh_ref)
    dw = cg.gru_bwd_dw(*common, carry_ref[4])
    dw_ref = cg.gru_bwd_dw_ref(*common, carry_ref[4])
    torch.cuda.synchronize()
    assert_close(torch, f"{case} gates GH", gh, gh_ref, 1e-5, 1e-5)
    errs = {"GH": max_err(gh, gh_ref)}
    for n, a, b in zip(("dgir", "dgiz", "dgin", "dh0", "dG"), carry,
                       carry_ref):
        tol = BF16_STREAM_TOL if (bf16 and n.startswith("dgi")) \
            else (2e-4, 2e-5)
        assert_close(torch, f"{case} carry {n}", a, b, *tol)
        errs[f"carry {n}"] = max_err(a, b)
    for n, a, b in zip(("dw_hh", "db_hh"), dw, dw_ref):
        scale = max(1.0, float(b.abs().max())) if bench_scale else 1.0
        assert_close(torch, f"{case} dW GEMM {n}", a, b, 2e-4, 2e-5, scale)
        errs[f"dW GEMM {n}"] = max_err(a, b, scale)
    log(f"  {'':<34} wide pieces against their plain pieces, max err: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + "  ok")
    return max(errs.values())


def check_sequence_layers(torch, cg, stream_dtype=None, H=64):
    """recurrent_N=2 through `cuda_gru.sequence` (the autograd path, the
    kernels for both layers) on the card, outputs and every gradient,
    against a plain path. In f32 that is the plain scan
    (`models/gru.scan_sequence`) on the same card, which differs by
    summation order only: 1e-5 on outputs and final states, rtol 2e-4 /
    atol 2e-5 on the gradients. With bf16 streams (bf16 input projections
    and LayerNorm) it is `cuda_gru.sequence` on the CPU, whose plain
    versions have the kernels' semantics (the bf16 scan has not); the two
    devices may round a value to its neighbour, and such a difference
    passes through two layers: rtol/atol 2e-2 on the bf16 outputs and on
    each gradient relative to its largest entry, 1e-2 on the f32 final
    states. At H=512 (f32) the weight gradients sum T·B products of
    512-long dot products, large against the absolute tolerance, so each
    f32 gradient is compared relative to its largest entry, as
    `check_layer` compares dW at the bench scale."""
    from onpolicy_torch.models import gru as gru_mod
    bf16 = stream_dtype is not None
    T, B, D, N = 10, 300, 24, 2
    gen_device = "cpu" if bf16 else "cuda"
    g = torch.Generator(device=gen_device).manual_seed(6 if bf16 else 5)
    rn = lambda *s, scale=1.0: torch.randn(*s, generator=g,
                                           device=gen_device) * scale
    layers, d_in = [], D
    for _ in range(N):
        layers.append({"w_ih": rn(d_in, 3 * H, scale=d_in ** -0.5),
                       "w_hh": rn(H, 3 * H, scale=H ** -0.5),
                       "b_ih": rn(3 * H, scale=0.1), "b_hh": rn(3 * H, scale=0.1)})
        d_in = H
    norm = {"scale": 1.0 + rn(H, scale=0.1), "bias": rn(H, scale=0.1)}
    xs, hxs = rn(T, B, D), rn(B, N, H, scale=0.5)
    masks = (torch.rand(T, B, 1, generator=g, device=gen_device)
             > 0.2).float()
    masks[0] = 0.0
    w_out = rn(H, 3, scale=H ** -0.5)   # keeps the loss's gradients O(1)

    def run(fn, device):
        t = lambda v: v.to(device).requires_grad_()
        p = {"layers": [{k: t(v) for k, v in l.items()} for l in layers],
             "norm": {k: t(v) for k, v in norm.items()}}
        x_, h_ = t(xs), t(hxs)
        outs, hT = fn(p, x_, h_, masks.to(device))
        loss = ((outs.float() @ w_out.to(device)) ** 2).sum() + (hT * hT).sum()
        leaves = [x_, h_] + [v for l in p["layers"] for v in l.values()] \
            + list(p["norm"].values())
        grads = torch.autograd.grad(loss, leaves)
        return [v.detach().float().cpu() for v in (outs, hT, *grads)]

    n0 = cg.FWD_LAUNCHES
    if bf16:
        kernels = lambda *a: cg.sequence(*a, stream_dtype)
        got, ref = run(kernels, "cuda"), run(kernels, "cpu")
    else:
        got, ref = run(cg.sequence, "cuda"), run(gru_mod.scan_sequence, "cuda")
    torch.cuda.synchronize()
    name = "bf16 layers=2" if bf16 else "layers=2"
    if cg.FWD_LAUNCHES - n0 != N:
        raise AssertionError(f"{name} did not launch the kernels")
    out_tol, h_tol = ((2e-2, 2e-2), (1e-2, 1e-2)) if bf16 \
        else ((1e-5, 1e-5), (1e-5, 1e-5))
    assert_close(torch, f"{name} outs", got[0], ref[0], *out_tol)
    assert_close(torch, f"{name} hT", got[1], ref[1], *h_tol)
    err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
    for i, (a, b) in enumerate(zip(got[2:], ref[2:])):
        scale = max(1.0, float(b.abs().max())) if (bf16 or H > 64) else 1.0
        assert_close(torch, f"{name} grad {i}", a, b,
                     *((2e-2, 2e-2) if bf16 else (2e-4, 2e-5)), scale)
        err = max(err, max_err(a, b, scale))
    against = "the CPU path" if bf16 else "the plain scan"
    log(f"  {'recurrent_N=2 autograd':<34} {'bf16' if bf16 else 'f32 '} "
        f"T={T:<3} B={B:<7} H={H:<4} against {against}: max err {err:.2e}  ok")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms_each(torch, fn, names, iters=20, attempts=3):
    """Device time per call of the kernels whose names contain each of
    `names`, from torch.profiler: {name: ms}, None where it saw no device
    time. At the flagship width the kernels take less than the host needs
    to launch them, so CUDA events around back-to-back calls read the
    host. Every call launches the same kernels, so each name's launch
    count is a whole multiple of `iters`; the profiler now and then loses
    launches (one reading held 1 of 20 forwards, under the bound), and
    such a reading is taken again."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out, counts = {}, {}
        for n in names:
            evs = [e for e in prof.key_averages() if n in e.key]
            us = sum(float(getattr(e, "self_device_time_total", 0.0)
                           or getattr(e, "self_cuda_time_total", 0.0))
                     for e in evs)
            out[n] = us / iters / 1e3 if us > 0 else None
            counts[n] = sum(e.count for e in evs)
        if all(c % iters == 0 for c in counts.values()):
            return out
        log(f"  torch.profiler lost launches ({counts} in {iters} calls); "
            "reading again")
    raise AssertionError(f"torch.profiler lost launches of {names} in "
                         f"{attempts} readings")


def device_ms(torch, fn, names, iters=20):
    """Device time per call of the kernels whose names contain one of
    `names`, summed; None if the profiler saw no device time."""
    ms = [v for v in device_ms_each(torch, fn, names, iters).values() if v]
    return sum(ms) if ms else None


# the forward's kernels, all named gru_fwd_*: the tensor-core, CUDA-core
# and wide step kernels; the backward's, all named gru_bwd_*: the
# tensor-core and CUDA-core kernels, and the wide variant's three and the
# reduction
FWD_KERNELS = ("gru_fwd_",)
BWD_KERNELS = ("gru_bwd_",)
WIDE_KERNELS = ("gru_bwd_gates_gemm", "gru_bwd_carry", "gru_bwd_dw_gemm",
                "gru_bwd_reduce")


def bounds(T, B, H, itemsize=4):
    """Least times in ms and what bounds them: each input read once and
    each output written once over the HBM rate, against the three hidden
    products (2*3*H^2*B*T flops forward, three times that backward). The
    [T, B, H] streams take `itemsize` bytes an element (4 f32, 2 bf16);
    the backward reads outs at steps 0..T-2 and h0 in their place at t = 0
    (hprev), also in the stream type. h0, hT, dhT, dh0, the masks, W and
    dW are f32. The products count on the f32 CUDA cores ("fwd",
    "bwd_f32") and in TF32 passes over the dense TF32 peak ("fwd_tc",
    "bwd_tc"). 3xTF32 takes three passes
    (hi·hi, hi·lo, lo·hi), one fewer where an operand is exact in TF32:
    the forward's h and W are f32, three passes each; in the backward
    with bf16 streams hm = hprev·m is bf16, so hm·W (gate recompute) and
    hm^T·dG (dW) take two passes and dG·W^T (carry) three, seven in all
    against nine with f32 streams. Gate elementwise math is not counted.
    The TF32 bounds are the card's best for the function at f32 accuracy,
    so they are the ones a kernel, CUDA-core or not, is held against."""
    seq, st, w = T * B * H * itemsize, B * H * 4, (3 * H * H + 3 * H) * 4
    m, hprev = T * B * 4, T * B * H * itemsize
    fwd_bytes = 3 * seq + m + st + w + seq + st
    bwd_bytes = 3 * seq + hprev + seq + m + st + w + 3 * seq + st + w
    fwd_flops = 6.0 * H * H * B * T
    bwd_passes = 7 if itemsize == 2 else 9
    out = {}
    for key, nbytes, ops_s in (
            ("fwd", fwd_bytes, fwd_flops / F32_FLOP_S),
            ("fwd_tc", fwd_bytes, 3 * fwd_flops / TF32_FLOP_S),
            ("bwd_f32", bwd_bytes, 3 * fwd_flops / F32_FLOP_S),
            ("bwd_tc", bwd_bytes, bwd_passes * fwd_flops / TF32_FLOP_S)):
        tb, tf = nbytes / HBM_BYTES_S * 1e3, ops_s * 1e3
        out[key] = (max(tb, tf), "bytes" if tb >= tf else "operations")
    return out


def time_shape(torch, cg, shape, card, stream_dtype=None):
    T, B, H = shape["T"], shape["B"], shape["H"]
    x = make_inputs(torch, T, B, H, seed=11, mask_mode="ones",
                    stream_dtype=stream_dtype)
    fargs = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
             x["b_hh"])
    outs, _ = cg.gru_layer_fwd_ref(*fargs)
    bargs = (x["gir"], x["giz"], x["gin"], outs, x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"], x["b_hh"])
    res = {
        "fwd_ms": time_ms(torch, lambda: cg.gru_layer_fwd(*fargs)),
        "bwd_ms": time_ms(torch, lambda: cg.gru_layer_bwd(*bargs)),
        "fwd_device_ms": device_ms(torch, lambda: cg.gru_layer_fwd(*fargs),
                                   FWD_KERNELS),
        "bwd_device_ms": device_ms(torch, lambda: cg.gru_layer_bwd(*bargs),
                                   BWD_KERNELS),
        "fwd_plain_ms": time_ms(torch, lambda: cg.gru_layer_fwd_ref(*fargs),
                                iters=5),
        "bwd_plain_ms": time_ms(torch, lambda: cg.gru_layer_bwd_ref(*bargs),
                                iters=5),
    }
    # yardstick only, never called by the port: cuDNN's GRU on all-ones
    # masks computes the same recurrence, plus the input projection; with
    # bf16 streams it runs wholly in bf16
    dt = stream_dtype or torch.float32
    gru = torch.nn.GRU(H, H).to("cuda", dt)
    gru.flatten_parameters()
    xin = torch.randn(T, B, H, device="cuda", dtype=dt, requires_grad=True)
    h0 = x["h0"][None].to(dt).clone()
    with torch.no_grad():
        res["fwd_library_ms"] = time_ms(torch, lambda: gru(xin, h0))
    y, _ = gru(xin, h0)
    dy = torch.randn_like(y)
    res["bwd_library_ms"] = time_ms(
        torch, lambda: torch.autograd.grad(y, [xin] + list(gru.parameters()),
                                           dy, retain_graph=True))
    b = bounds(T, B, H, x["gir"].element_size())
    res["fwd_bound_f32_ms"], res["fwd_bound_f32_by"] = b["fwd"]
    res["fwd_bound_tc_ms"], res["fwd_bound_tc_by"] = b["fwd_tc"]
    res["bwd_bound_f32_ms"], res["bwd_bound_f32_by"] = b["bwd_f32"]
    res["bwd_bound_tc_ms"], res["bwd_bound_tc_by"] = b["bwd_tc"]
    itemsize = x["gir"].element_size()
    res["fwd_variant"] = cg.device_fwd_plan(torch.device("cuda"), B, H,
                                            itemsize).name
    bplan = cg.device_bwd_plan(torch.device("cuda"), B, H, itemsize, T)
    res["bwd_variant"] = bplan.name
    res["streams"] = "bf16" if itemsize == 2 else "f32"
    res["bwd_scratch_bytes"] = 4 * bplan.partial_floats
    if bplan.variant == cg.WIDE:
        res["bwd_device_ms_by_kernel"] = device_ms_each(
            torch, lambda: cg.gru_layer_bwd(*bargs), WIDE_KERNELS, iters=5)
    log(f"  times {res['streams']} T={T} B={B} H={H} [{card}]: "
        + json.dumps(res))
    return res


# phase 4's LayerNorm shapes (rows, width): t16k's feature, hidden and GRU
# norms and MAT's embedding width over its 1,228,800 update rows; f1000's
# hidden width and its actor and critic feature widths over 200,000 rows;
# MAT's decode at act time (49,152 slots)
LN_SHAPES = ((1_228_800, 18), (1_228_800, 54), (1_228_800, 64),
             (200_000, 512), (200_000, 660), (200_000, 785), (49_152, 64))


def ln_bounds_ms(N, D):
    """Least times in ms at 3.35 TB/s: the forward reads x and writes y,
    the backward reads x, dy and scale and writes dx (f32)."""
    return (8 * N * D / HBM_BYTES_S * 1e3,
            (12 * N * D + 4 * D) / HBM_BYTES_S * 1e3)


def ln_param_grads_err(torch, got, x, dy, mean, rstd):
    """The larger error of the kernels' dscale and dbias against float64
    sums of the same terms (over x's normalised by the kernel's mean and
    rstd), each as a share of its limit: 1e-6 of the sum of the terms'
    magnitudes, the f32 rounding of sums of that many terms (as
    tests/test_torch_layer_norm.py holds them)."""
    D = x.shape[-1]
    xh = ((x.double() - mean.double()[..., None])
          * rstd.double()[..., None]).reshape(-1, D)
    d = dy.double().reshape(-1, D)
    share = 0.0
    for g, terms in zip(got, (d * xh, d)):
        err = float((g.double() - terms.sum(0)).abs().max())
        share = max(share, err / (1e-6 * float(terms.abs().sum(0).max())))
    return share


def time_layer_norm(torch, card):
    """The LayerNorm kernels (`ops/cuda_layer_norm.py`) at `LN_SHAPES`:
    each held to its plain twin (y, the saved mean and rstd, and dx against
    the twin's backward on the twin's own statistics; dscale and dbias
    against float64 sums, `ln_param_grads_err`), then CUDA-event ms and
    device ms of the forward and the backward (with its reduction), beside
    the bytes bound, the plain twins' ms, the decomposed form's (the port's
    LayerNorm before the kernels: forward, and autograd's backward) and
    `F.layer_norm`'s (yardstick only, never called by the port). Returns
    the `kernels` line's rows."""
    import torch.nn.functional as F
    from onpolicy_torch.models import common as cm
    from onpolicy_torch.ops import cuda_layer_norm as cln
    rows = []
    eps = cm.LN_EPS
    for N, D in LN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(N + D)
        x = torch.randn(N, D, device="cuda", generator=g) * 1.5 + 0.5
        dy = torch.randn(N, D, device="cuda", generator=g)
        scale = 1.0 + 0.3 * torch.randn(D, device="cuda", generator=g)
        bias = 0.1 * torch.randn(D, device="cuda", generator=g)
        y, mean, rstd = cln.layer_norm_fwd(x, scale, bias, eps)
        ry, rmean, rrstd = cln.layer_norm_fwd_ref(x, scale, bias, eps)
        dx, ds, db = cln.layer_norm_bwd(x, scale, dy, mean, rstd)
        rdx, rds, rdb = cln.layer_norm_bwd_ref(x, scale, dy, rmean, rrstd)
        errs = {"fwd": max(max_err(y, ry), max_err(mean, rmean),
                           max_err(rstd, rrstd)),
                "bwd": max(max_err(dx, rdx),
                           max_err(ds, rds, float(rds.abs().max())),
                           max_err(db, rdb, float(rdb.abs().max())))}
        at = f"N={N} D={D}"
        assert_close(torch, f"layernorm y {at}", y, ry, 1e-5, 1e-5)
        assert_close(torch, f"layernorm mean {at}", mean, rmean, 1e-5, 1e-5)
        assert_close(torch, f"layernorm rstd {at}", rstd, rrstd, 1e-5, 1e-5)
        assert_close(torch, f"layernorm dx {at}", dx, rdx, 1e-4, 1e-5)
        share = ln_param_grads_err(torch, (ds, db), x, dy, mean, rstd)
        if share > 1.0:
            raise AssertionError(f"layernorm dscale / dbias {at}: {share:.3f}"
                                 " of the limit from float64 sums")
        fwd = lambda: cln.layer_norm_fwd(x, scale, bias, eps)
        bwd = lambda: cln.layer_norm_bwd(x, scale, dy, mean, rstd)
        xs = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
        with torch.no_grad():
            lib_fwd = time_ms(torch, lambda: F.layer_norm(x, (D,), scale, bias,
                                                          eps))
        ly = F.layer_norm(xs[0], (D,), xs[1], xs[2], eps)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
            ly, xs, dy, retain_graph=True))
        p = {"scale": xs[1], "bias": xs[2]}
        decomposed = lambda: cm.layer_norm_apply(p, xs[0])
        real_rule = cln.served_by_kernels
        cln.served_by_kernels = lambda device, dtype: False
        try:
            with torch.no_grad():
                dec_fwd = time_ms(torch, decomposed, iters=5)
            dy_ = decomposed()
            dec_bwd = time_ms(torch, lambda: torch.autograd.grad(
                dy_, xs, dy, retain_graph=True), iters=5)
        finally:
            cln.served_by_kernels = real_rule
        bound = dict(zip(("fwd", "bwd"), ln_bounds_ms(N, D)))
        times = {
            "fwd": (time_ms(torch, fwd), device_ms(torch, fwd, ("ln_fwd",)),
                    time_ms(torch, lambda: cln.layer_norm_fwd_ref(
                        x, scale, bias, eps), iters=5), lib_fwd, dec_fwd),
            "bwd": (time_ms(torch, bwd), device_ms(torch, bwd, ("ln_bwd",)),
                    time_ms(torch, lambda: cln.layer_norm_bwd_ref(
                        x, scale, dy, mean, rstd), iters=5), lib_bwd, dec_bwd)}
        pl = cln.plan(D)
        for d, name in (("fwd", "ln_fwd"), ("bwd", "ln_bwd")):
            ms, dev, plain, lib, dec = times[d]
            rows.append({
                "name": name, "route": "cuda",
                "source": "onpolicy_torch/csrc/layer_norm.cu",
                "replaces": "decomposed ops (models/common.layer_norm_apply);"
                            " no TPU kernel",
                "streams": "f32", "shape": {"N": N, "D": D},
                "variant": f"{pl.name} L={pl.lanes} V={pl.vec} C={pl.chunks}",
                "max_abs_err": errs[d], "ms": ms, "device_ms": dev,
                "plain_ms": plain, "decomposed_ms": dec,
                "bound_ms": bound[d], "bound_by": "bytes",
                "library_ms": lib})
            if d == "bwd":
                rows[-1]["param_grads_of_limit"] = share
            log(f"  layernorm {d} N={N} D={D} [{card}]: "
                + json.dumps(rows[-1]))
    return rows


def compare_forwards(torch, cg, shape, card):
    """The CUDA-core forward against the one the shape takes (the
    tensor-core one at H=64, the wide one at H=512) on the same inputs,
    each through an explicit plan: each held against the plain version
    (outs and hT at 1e-5), then timed in turns (CUDA-core, new, new,
    CUDA-core) so that both see the same card: CUDA-event ms and
    torch.profiler device ms of each turn."""
    T, B, H = shape["T"], shape["B"], shape["H"]
    x = make_inputs(torch, T, B, H, seed=13, mask_mode="ones")
    fargs = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
             x["b_hh"])
    limits = cg.device_limits(torch.cuda.current_device())
    new = cg.fwd_plan(B, H, *limits)
    plans = {"cuda_core": cg.cuda_core_fwd_plan(B, H, *limits),
             new.name: new}
    ref = cg.gru_layer_fwd_ref(*fargs)
    res = {}
    for k, p in plans.items():
        got = cg.gru_layer_fwd(*fargs, plan=p)
        torch.cuda.synchronize()
        for n, a, b in zip(("outs", "hT"), got, ref):
            assert_close(torch, f"T={T} B={B} H={H} {p.name} {n}", a, b,
                         1e-5, 1e-5)
        res[k] = {"plan": p._asdict(), "variant": p.name,
                  "max_err": max(max_err(a, b) for a, b in zip(got, ref)),
                  "event_ms": [], "device_ms": []}
    del got, ref
    slow = H > 64   # the CUDA-core forward at H=512 takes ~36 ms a call
    for k in ("cuda_core", new.name, new.name, "cuda_core"):
        fn = lambda: cg.gru_layer_fwd(*fargs, plan=plans[k])
        res[k]["event_ms"].append(time_ms(torch, fn, iters=10 if slow else 20))
        res[k]["device_ms"].append(device_ms(torch, fn, FWD_KERNELS,
                                             iters=10 if slow else 20))
    log(f"  forward in turns T={T} B={B} H={H} [{card}]: " + json.dumps(res))
    return res


def compare_backwards(torch, cg, shape, card):
    """The CUDA-core backward (`cuda_core_bwd_plan`) and the wide one on
    the same inputs, each through an explicit plan: each held against the
    plain version (`check_bwd_outputs`, dW and db relative to their
    largest entry), then timed in turns (CUDA-core, wide, wide,
    CUDA-core): CUDA-event ms and torch.profiler device ms of each turn,
    each wide kernel's device ms, and each plan's scratch bytes."""
    T, B, H = shape["T"], shape["B"], shape["H"]
    x = make_inputs(torch, T, B, H, seed=13, mask_mode="ones")
    fargs = (x["gir"], x["giz"], x["gin"], x["h0"], x["masks"], x["w_hh"],
             x["b_hh"])
    outs, _ = cg.gru_layer_fwd_ref(*fargs)
    bargs = (x["gir"], x["giz"], x["gin"], outs, x["h0"], x["masks"],
             x["douts"], x["dhT"], x["w_hh"], x["b_hh"])
    n_sm, optin = cg.device_limits(torch.cuda.current_device())
    plans = {"cuda_core": cg.cuda_core_bwd_plan(B, H, n_sm, optin),
             "wide": cg.bwd_plan(B, H, n_sm, optin, 4, T)}
    ref = cg.gru_layer_bwd_ref(*bargs)
    res = {}
    for k, p in plans.items():
        got = cg.gru_layer_bwd(*bargs, plan=p)
        torch.cuda.synchronize()
        errs = check_bwd_outputs(torch, f"T={T} B={B} H={H} {p.name}", got,
                                 ref, False, True)
        res[k] = {"plan": p._asdict(), "variant": p.name,
                  "scratch_bytes": 4 * p.partial_floats,
                  "max_err": max(errs.values()), "event_ms": [],
                  "device_ms": []}
    del got, ref
    for k in ("cuda_core", "wide", "wide", "cuda_core"):
        fn = lambda: cg.gru_layer_bwd(*bargs, plan=plans[k])
        slow = k == "cuda_core"
        res[k]["event_ms"].append(time_ms(torch, fn, iters=3 if slow else 20,
                                          warmup=1 if slow else 3))
        each = device_ms_each(torch, fn, WIDE_KERNELS + ("gru_bwd_kernel",),
                              iters=3 if slow else 10)
        res[k]["device_ms"].append(sum(v for v in each.values() if v))
        if not slow:
            res[k].setdefault("device_ms_by_kernel", []).append(each)
    log(f"  backward in turns T={T} B={B} H={H} [{card}]: " + json.dumps(res))
    return res


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

# the update's metrics that phase 5 holds the card's to the CPU's
UPDATE_METRICS = ("value_loss", "dist_entropy", "actor_grad_norm",
                  "critic_grad_norm", "grad_norm", "kl", "loss_improve")


def check_update_against_cpu(torch, name, old, new, metrics, tol,
                             update_tol):
    """The card's update against the CPU's from the same state: `old` and
    `new` are (card, CPU) pairs of tuples of train states, `metrics` the
    (card, CPU) metrics. Each of `UPDATE_METRICS` within rtol `tol[0]`;
    for each parameter tree (MAPPO's, HAPPO's and HATRPO's actor and
    critic, MAT's one), the card's update (new - old parameters) differs
    from the CPU's by at most `update_tol` of the CPU's norm, and every
    trained parameter agrees within `tol`. → ({tree: that ratio}, the
    largest parameter error)."""
    from onpolicy_torch.utils.tree import tree_leaves
    m_g, m_c = metrics
    for k in m_c:
        if k.split("/")[-1] in UPDATE_METRICS:
            a, b = float(m_g[k]), float(m_c[k])
            if not abs(a - b) <= tol[0] * abs(b):
                raise AssertionError(f"{name} train {k}: card {a:.6g}, CPU "
                                     f"{b:.6g} (rtol {tol[0]})")
    leaves = lambda states, part: [x for s in states
                                   for x in tree_leaves(getattr(s, part))]
    moved, err = {}, 0.0
    for part in [f.name for f in dataclasses.fields(new[1][0])
                 if f.name.endswith("params")]:
        step = lambda n, o: torch.cat([(a - b).flatten().cpu() for a, b in
                                       zip(leaves(n, part), leaves(o, part))])
        d_g, d_c = step(new[0], old[0]), step(new[1], old[1])
        moved[part] = float((d_g - d_c).norm() / d_c.norm())
        if not moved[part] <= update_tol:
            raise AssertionError(
                f"{name} train {part}: card's update differs from the CPU's "
                f"by {moved[part]:.3e} of its norm (limit {update_tol})")
        for i, (a, b) in enumerate(zip(leaves(new[0], part),
                                       leaves(new[1], part))):
            assert_close(torch, f"{name} train {part}[{i}]", a.cpu(), b, *tol)
            err = max(err, max_err(a.cpu(), b))
    return moved, err


def check_small_against_cpu(torch, name, tol, update_tol, **flags):
    """One episode at 8 rollout threads, on the card (kernels) and on the
    CPU (plain versions) from the same parameters, carry and actions;
    through the separated runner (every agent's buffer, trainer and
    update; HAPPO's agents in the order 2, 1, 0) when the flags ask for
    separated policies. Each rollout field must agree within `tol` (rtol,
    atol) relative to its largest entry; the update's value loss, entropy
    and gradient norms within rtol `tol[0]`; the trained parameters within
    `tol`. In f32 the sums reorder between cuBLAS/the kernels and the CPU,
    and the differences pass through 25 env steps and 2 PPO epochs of
    Adam: 1e-3 / 1e-4. In bf16 the two devices may round a bf16 value to
    its neighbour, as tests/test_bf16.py allows between JAX's bf16 model
    and its f32 one: 5e-2 / 5e-2.
    Two Adam steps at lr 7e-4 move a parameter by at most ~1.4e-3, below
    those tolerances, so the update itself (new - old parameters, all
    leaves of the actors, then of the critics) is held to the CPU's by the
    norm of the difference over the norm of the CPU's update: at most
    `update_tol`. A missing update reads 1, one of the wrong sign 2. On
    an H100 the readings were 2.7e-6 (actor) and 7.5e-6 (critic) in f32,
    hence 1e-3; 1.8e-2 / 2.1e-2 (rMAPPO) and 9.1e-3 / 5.6e-2 (MAPPO with
    the critic dedup) in bf16, where bf16 rounding can turn the sign of
    Adam's first step for a parameter of near-zero gradient, hence 0.25.
    MAT's one parameter tree is held as the actor's and critic's are;
    HATRPO's update is one TRPO step an agent (critic Adam step, CG,
    line search), and its KL and improvement are held to rtol `tol[0]`
    too."""
    from onpolicy_torch.config import Config, canonicalize_algorithm
    from onpolicy_torch.envs.mpe.world import WorldState
    from onpolicy_torch.scripts.train_mpe import make_runner
    from onpolicy_torch.utils.tree import tree_map
    base = canonicalize_algorithm(Config(
        n_rollout_threads=8, episode_length=25, num_env_steps=200,
        ppo_epoch=2, use_ReLU=False, lr=7e-4, critic_lr=7e-4, **flags))
    separated = not base.share_policy
    gpu = make_runner(base.replace(device="cuda"))
    cpu = make_runner(base.replace(device="cpu"))
    ts_g, carry_g = gpu.init()
    ts_c, _ = cpu.init()
    to_cpu = lambda c: {**tree_map(lambda t: t.cpu(), {
        k: v for k, v in c.items() if k != "env_states"}),
        "env_states": WorldState.from_tensors(
            tree_map(lambda t: t.cpu(), c["env_states"].tensors()))}
    carry_c = to_cpu(carry_g)
    after_g, buf_g = gpu.rollout(ts_g, carry_g)
    bufs_g = buf_g if separated else [buf_g]
    T = base.episode_length
    inject = [{"actions": [b.actions[t, :, 0].cpu() for b in bufs_g]
               if separated else buf_g.actions[t].cpu()} for t in range(T)]
    inject[-1]["reset_states"] = to_cpu(after_g)["env_states"]
    _, buf_c = cpu.rollout(ts_c, carry_c, inject)
    bufs_c = buf_c if separated else [buf_c]
    err = 0.0
    for i, (bg, bc) in enumerate(zip(bufs_g, bufs_c)):
        for k in ("obs", "rewards", "action_log_probs", "value_preds",
                  "rnn_states", "returns", "advantages"):
            a, b = getattr(bg, k).cpu(), getattr(bc, k)
            scale = float(b.abs().max()) or 1.0
            assert_close(torch, f"{name} rollout {i} {k}", a, b, *tol, scale)
            err = max(err, max_err(a, b, scale))
    if separated:
        order = tuple(reversed(range(gpu.num_agents)))
        new_g, m_g = gpu.update(ts_g, bufs_g, order)
        new_c, m_c = cpu.update(ts_c, bufs_c, order)
    else:
        (new_g, m_g), (new_c, m_c) = (
            gpu.algo.train(ts_g, buf_g, gpu.generator),
            cpu.algo.train(ts_c, buf_c, cpu.generator))
        ts_g, ts_c, new_g, new_c = ((x,) for x in (ts_g, ts_c, new_g, new_c))
    torch.cuda.synchronize()
    moved, perr = check_update_against_cpu(
        torch, name, (ts_g, ts_c), (new_g, new_c), (m_g, m_c), tol,
        update_tol)
    err = max(err, perr)
    log(f"  card vs CPU, {name}, 1 episode at N=8: max err {err:.2e} "
        f"(rollout relative to each field's largest entry), update differs "
        "by " + " / ".join(f"{v:.3e} ({k})" for k, v in moved.items())
        + " of its norm  ok")


def check_models_against_cpu(torch, cg, tol=(1e-3, 1e-4)):
    """The heads and the base this slice added, on the card against the
    CPU from the same parameters and inputs, at a small size: an MLP actor
    (8 features) with the Box, the MultiBinary and the mixed Box+Discrete
    head, and an `Actor` / `Critic` pair on a Box((4, 10, 10)) image space
    (the CNN base), all recurrent at hidden 32 (the card's sequence GRU is
    the kernels), over [L=5, B=24] sequences: the log-probs, the entropy,
    the values and the gradient of every parameter of both networks, each
    within `tol` relative to its largest entry (phase 5's f32
    tolerance)."""
    from onpolicy_torch.config import Config
    from onpolicy_torch.models import actor_critic
    from onpolicy_torch.utils import spaces as sp
    from onpolicy_torch.utils.tree import tree_leaves, tree_map
    cfg = Config(hidden_size=32, use_ReLU=False, gain=0.5, device="cpu")
    L, B = 5, 24
    err, f0 = 0.0, cg.FWD_LAUNCHES
    for name, obs_space, act_space in (
            ("box head", sp.Box((8,)), sp.Box((3,))),
            ("multibinary head", sp.Box((8,)), sp.MultiBinary(4)),
            ("mixed head", sp.Box((8,)), sp.MixedSpace(2, 4)),
            ("cnn base", sp.Box((4, 10, 10)), sp.Discrete(5))):
        actor = actor_critic.Actor(cfg, obs_space, act_space)
        critic = actor_critic.Critic(cfg, obs_space)
        g = torch.Generator().manual_seed(0)
        params = [actor.init(g, "cpu"), critic.init(g, "cpu")]
        scale = 255.0 if name == "cnn base" else 2.0
        obs = torch.rand(L, B, *obs_space.shape, generator=g) * scale
        h0 = torch.randn(B, 1, 32, generator=g) * 0.5
        masks = (torch.rand(L, B, 1, generator=g) > 0.2).float()
        actions, _, _ = actor.forward(
            params[0], obs.reshape(L * B, *obs_space.shape),
            h0.repeat(L, 1, 1), masks.reshape(L * B, 1), g)
        actions = actions.reshape(L, B, -1)

        def run(device):
            p = tree_map(lambda x: x.to(device).requires_grad_(True), params)
            to = lambda x: x.to(device)
            lp, ent = actor.evaluate_seq(p[0], to(obs), to(h0), to(actions),
                                         to(masks))
            v = critic.forward_seq(p[1], to(obs), to(h0), to(masks))
            grads = torch.autograd.grad(
                lp.sum() + ent + v.square().sum(), tree_leaves(p))
            return [x.detach().cpu() for x in (lp, ent, v, *grads)]
        got, want = run("cuda"), run("cpu")
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            what = ("log_probs", "entropy", "values")[i] if i < 3 \
                else f"grad[{i - 3}]"
            big = float(b.abs().max()) or 1.0
            assert_close(torch, f"{name} {what}", a, b, *tol, big)
            err = max(err, max_err(a, b, big))
    if cg.FWD_LAUNCHES == f0:
        raise AssertionError("the models' sequence GRU launched no kernel")
    log(f"  card vs CPU, the Box, MultiBinary and mixed heads and the CNN "
        f"base (L={L} B={B} H=32): log-probs, entropy, values and every "
        f"gradient, max err {err:.2e} relative to each one's largest entry"
        "  ok")


def check_scenarios_against_cpu(torch, steps=26, n_envs=16,
                                tol=(1e-4, 1e-4)):
    """Each scenario of `SCENARIO_CHECKS` stepped on the card and on the
    CPU in f32 from the same resets (drawn on the CPU), the same random
    actions and, where the world has noise, the same standard normal
    draws; every env finishes at step 25 and restarts from the same
    injected worlds. Observations, rewards and positions agree within
    `tol` (rtol, atol) at every step; the sums of the collision, wall and
    distance terms reorder between the two devices."""
    from onpolicy_torch.envs.mpe import world as world_lib
    from onpolicy_torch.envs.mpe.env import MPEEnv, MPEVecEnv
    from onpolicy_torch.envs.mpe.world import WorldState
    from onpolicy_torch.utils.tree import tree_map
    worst = {}
    for case, name, M, K, good, adv, special in SCENARIO_CHECKS:
        env = MPEEnv(name, M, K, 25, good, adv)
        if special:
            env.spec = dataclasses.replace(
                env.spec,
                walls=(world_lib.WallSpec("H", 0.3, (-0.5, 0.6)),
                       world_lib.WallSpec("V", -0.2, (-0.8, 0.4), 0.2, False)),
                agent_ghost=tuple(i % 2 == 1 for i in range(M)),
                agent_u_noise=(0.3,) * M,
                agent_c_noise=(0.5,) + (None,) * (M - 1))
        g = torch.Generator().manual_seed(7)
        vecs = {d: MPEVecEnv(env, n_envs, d, torch.Generator(device=d))
                for d in ("cuda", "cpu")}
        on = lambda st, d: WorldState.from_tensors(
            tree_map(lambda t: t.to(d), st.tensors()))
        state, _ = env.reset(n_envs, g, "cpu")
        states = {d: on(state, d) for d in vecs}
        heads = [getattr(s, "nvec", None) or (s.n,) for s in env.action_space]
        width = max(len(h) for h in heads)
        err = 0.0
        for t in range(steps):
            acts = torch.stack([torch.stack(
                [torch.randint(0, h[c] if c < len(h) else 1, (n_envs,),
                               generator=g) for c in range(width)], -1)
                for h in heads], 1)
            resets, _ = env.reset(n_envs, g, "cpu")
            noise = env.draw_noise(n_envs, g, state.agent_pos)
            out = {}
            for d, vec in vecs.items():
                to = lambda x: tree_map(lambda y: y.to(d), x)
                out[d] = vec.step(states[d], acts.to(d), on(resets, d),
                                  to(noise))
                states[d] = out[d][0]
            (s_g, o_g, r_g, d_g), (s_c, o_c, r_c, d_c) = (out["cuda"],
                                                          out["cpu"])
            if not torch.equal(d_g.cpu(), d_c):
                raise AssertionError(f"{case} step {t}: dones differ")
            pairs = [(f"obs {i}", a, b) for i, (a, b) in enumerate(zip(o_g,
                                                                      o_c))]
            pairs += [("rewards", r_g, r_c),
                      ("agent_pos", s_g.agent_pos, s_c.agent_pos)]
            for what, a, b in pairs:
                assert_close(torch, f"{case} step {t} {what}", a.cpu(), b,
                             *tol)
                err = max(err, max_err(a.cpu(), b))
        worst[case] = err
    log(f"  card vs CPU, MPE scenarios, {steps} steps of {n_envs} envs (an "
        f"auto-reset at 25), f32, max abs err: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + "  ok")


def check_hanabi_against_cpu(torch, cg, name, argv, tol=(1e-3, 1e-4),
                             update_tol=1e-3):
    """A Hanabi runner of `argv` (2 agents) on the card and on the CPU, from
    the same parameters, each policy's mode taken: an untrained episode,
    then a trained one (the deferred update on the first episode's buffer).
    The device round loop takes the same decks on both; the host seat loop
    plays both C++ engines from the same seed. Each buffer field must
    agree within `tol` relative to its largest entry; the update's metrics
    within rtol `tol[0]`; the update itself (new - old parameters) differs
    by at most `update_tol` of its norm, and the trained parameters agree
    within `tol`, as `check_small_against_cpu` holds the f32 MPE runs. A
    recurrent policy's update launches the backward kernel twice an epoch
    (actor and critic), a feed-forward one no GRU kernel."""
    from onpolicy_torch.envs.hanabi import torch_engine as te
    from onpolicy_torch.runner.hanabi_runner import HanabiRunner
    from onpolicy_torch.scripts.train_hanabi import config_from_args
    gpu = HanabiRunner(config_from_args(argv + ["--device", "cuda"]))
    cpu = HanabiRunner(config_from_args(argv + ["--device", "cpu"]))
    gpu.det_collect = cpu.det_collect = True
    T = gpu.cfg.episode_length
    if gpu.host_loop:
        decks = [None] * (2 * T + 1)
        episode = lambda r, ts, c, b, do_train, ds: r.episode(ts, c, b,
                                                              do_train)
    else:
        g = torch.Generator().manual_seed(3)
        decks = [te.shuffled_decks(gpu.envs.game, gpu.N, g, "cpu")
                 for _ in range(2 * T + 1)]
        episode = lambda r, ts, c, b, do_train, ds: r._device_episode(
            ts, c, b, do_train, ds)
    on_card = lambda d: None if d is None else d.cuda()
    ts_g, c_g, b_g = gpu.init(on_card(decks[0]))
    ts_c, c_c, b_c = cpu.init(decks[0])
    err = 0.0
    launches = cg.FWD_LAUNCHES, cg.BWD_LAUNCHES
    for ep, do_train in enumerate((False, True)):
        ds = decks[1 + ep * T:1 + (ep + 1) * T]
        old_g, old_c = ts_g, ts_c
        ts_g, c_g, b_g, m_g = episode(gpu, ts_g, c_g, b_g, do_train,
                                      [on_card(d) for d in ds])
        ts_c, c_c, b_c, m_c = episode(cpu, ts_c, c_c, b_c, do_train, ds)
        torch.cuda.synchronize()
        for k, b in b_c.items():
            a = b_g[k].cpu()
            scale = float(b.abs().max()) or 1.0
            assert_close(torch, f"{name} episode {ep} buffer {k}", a, b,
                         *tol, scale)
            err = max(err, max_err(a, b, scale))
        if not do_train:
            continue
        moved, perr = check_update_against_cpu(
            torch, name, ((old_g,), (old_c,)), ((ts_g,), (ts_c,)),
            (m_g, m_c), tol, update_tol)
        err = max(err, perr)
    fwd = cg.FWD_LAUNCHES - launches[0]
    bwd = cg.BWD_LAUNCHES - launches[1]
    if gpu.cfg.use_recurrent_policy:
        if bwd != 2 * gpu.cfg.ppo_epoch or fwd < bwd:
            raise AssertionError(f"{name}: the update launched fwd {fwd} bwd "
                                 f"{bwd} GRU kernels, want bwd "
                                 f"{2 * gpu.cfg.ppo_epoch}")
    elif (fwd, bwd) != (0, 0):
        raise AssertionError(f"{name}: a feed-forward policy launched GRU "
                             f"kernels (fwd {fwd} bwd {bwd})")
    log(f"  card vs CPU, {name}, 2 episodes at N={gpu.N}: max err {err:.2e} "
        f"(buffer relative to each field's largest entry), update differs by "
        f"{moved['actor_params']:.3e} (actor) / {moved['critic_params']:.3e} "
        f"(critic) of its norm, GRU launches fwd {fwd} bwd {bwd}  ok")


def check_host_against_cpu(torch, cg, name, config, episode_length=40,
                           tol=(1e-3, 1e-4), update_tol=1e-3):
    """One host-runner episode of `train_smac.CONFIGS[config]` at T =
    `episode_length` on the card and on the CPU, each over its own
    in-process pool of stand-in engines from the same seeds and from the
    same parameters, the card's actions injected into the CPU's rollout.
    Each staged field and the returns agree within `tol` relative to the
    field's largest entry; the update's metrics within rtol `tol[0]`; the
    update (new - old parameters) differs by at most `update_tol` of its
    norm and the trained parameters within `tol`
    (`check_update_against_cpu`, the limits of `check_small_against_cpu`
    in f32). HAPPO's agents train in the order M-1, ..., 0. The update
    must launch the kernels."""
    from onpolicy_torch.envs.host_vec import DummyVecEnv
    from onpolicy_torch.runner.host_runner import HostSharedRunner
    from onpolicy_torch.runner.host_separated_runner import \
        HostSeparatedRunner
    from onpolicy_torch.scripts import train_smac
    runners = {}
    for device in ("cuda", "cpu"):
        ns, cfg = train_smac.config_from_args(
            train_smac.CONFIGS[config] + [
                "--episode_length", str(episode_length), "--use_eval",
                "false", "--device", device])
        envs = DummyVecEnv(train_smac.make_env_fns(
            ns, cfg, cfg.n_rollout_threads, cfg.seed), protocol="share")
        Runner = HostSeparatedRunner if cfg.algorithm_name == "happo" \
            else HostSharedRunner
        runners[device] = Runner(cfg, envs)
    gpu, cpu = runners["cuda"], runners["cpu"]
    try:
        (ts_g, start_g), (ts_c, start_c) = gpu.init(), cpu.init()
        _, buf_g, _ = gpu.rollout(ts_g, start_g)
        inject = [{"actions": buf_g.actions[t].cpu().numpy()}
                  for t in range(episode_length)]
        _, buf_c, _ = cpu.rollout(ts_c, start_c, inject)
        err = 0.0
        for k in ("obs", "share_obs", "available_actions", "rewards",
                  "masks", "active_masks", "bad_masks", "action_log_probs",
                  "value_preds", "rnn_states", "rnn_states_critic",
                  "returns", "advantages"):
            a, b = getattr(buf_g, k).cpu(), getattr(buf_c, k)
            scale = float(b.abs().max()) or 1.0
            assert_close(torch, f"{name} rollout {k}", a, b, *tol, scale)
            err = max(err, max_err(a, b, scale))
        deaths = int((buf_c.active_masks == 0).sum())
        launches = cg.FWD_LAUNCHES, cg.BWD_LAUNCHES
        if isinstance(gpu, HostSeparatedRunner):
            order = tuple(reversed(range(gpu.num_agents)))
            (new_g, m_g), (new_c, m_c) = (gpu.update(ts_g, buf_g, order),
                                          cpu.update(ts_c, buf_c, order))
        else:
            (new_g, m_g), (new_c, m_c) = (gpu.update(ts_g, buf_g),
                                          cpu.update(ts_c, buf_c))
            ts_g, ts_c, new_g, new_c = ((x,) for x in (ts_g, ts_c, new_g,
                                                       new_c))
        torch.cuda.synchronize()
        fwd = cg.FWD_LAUNCHES - launches[0]
        bwd = cg.BWD_LAUNCHES - launches[1]
        if not (fwd and bwd):
            raise AssertionError(f"{name}: the update launched fwd {fwd} "
                                 f"bwd {bwd} GRU kernels")
        moved, perr = check_update_against_cpu(
            torch, name, (ts_g, ts_c), (new_g, new_c), (m_g, m_c), tol,
            update_tol)
        err = max(err, perr)
    finally:
        gpu.envs.close()
        cpu.envs.close()
    log(f"  card vs CPU, {name}, 1 episode of T={episode_length}: max err "
        f"{err:.2e} (staged buffer and returns relative to each field's "
        f"largest entry; {deaths} dead agent-steps), update differs by "
        + " / ".join(f"{v:.3e} ({k})" for k, v in moved.items())
        + f" of its norm, GRU launches fwd {fwd} bwd {bwd}  ok")


def train_main_path(torch, cg, name, script, config, extra, episodes,
                    fwd_per_episode, bwd_per_episode, evaluate=False):
    """`scripts/<script>.main` with its `CONFIGS[config]` and the `extra`
    flags for `episodes` episodes, the launch counts (GRU and LayerNorm)
    set to 0 just before and read just after. Every logged metric must be
    finite; a run in f32 (no `--use_bf16`) must have launched the LayerNorm
    kernels both ways (every model's LayerNorms run there; under bf16 they
    keep the decomposed ops); and each GRU kernel launched its given count
    a trained episode: every episode of
    train_mpe (an eval logged each episode with `--use_eval`), all but the
    first of train_hanabi (training is deferred one episode, and the first
    is not logged). Where the forward is the wide one it launches its step
    kernel T = data_chunk_length times a forward. Every parameter of the
    trained state must be on the card. With `evaluate`, the checkpoint the
    run saved is evaluated by `scripts/eval_hanabi.main` with
    scripts/eval_hanabi_forward.sh's flags (the C++ engine) over 8 games.
    Returns (fwd launches, bwd launches, env-steps/s over the run,
    env-steps/s of the last episode, LayerNorm launches {"fwd", "bwd"})."""
    import importlib

    from onpolicy_torch.ops import cuda_layer_norm as cln
    module = importlib.import_module(f"onpolicy_torch.scripts.{script}")
    hanabi = script == "train_hanabi"
    argv = module.CONFIGS[config] + list(extra) + [
        "--experiment_name", f"chip_smoke_{config}", "--log_interval", "1",
        "--device", "cuda"]
    flag = lambda name: int(argv[argv.index(name) + 1])
    threads = flag("--n_rollout_threads")
    steps = flag("--episode_length") * threads
    argv += ["--num_env_steps", str(episodes * steps)]
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["ONPOLICY_TORCH_RESULTS"] = tmp
        cg.FWD_LAUNCHES = 0
        cg.BWD_LAUNCHES = 0
        cg.FWD_STEP_LAUNCHES = 0
        cg.WIDE_LAUNCHES = dict.fromkeys(cg.WIDE_LAUNCHES, 0)
        cln.FWD_LAUNCHES = 0
        cln.BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        state, history = module.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwd, bwd = cg.FWD_LAUNCHES, cg.BWD_LAUNCHES
        ln = {"fwd": cln.FWD_LAUNCHES, "bwd": cln.BWD_LAUNCHES}
        fwd_steps = cg.FWD_STEP_LAUNCHES
        pieces = dict(cg.WIDE_LAUNCHES)
        if evaluate:
            from onpolicy_torch.scripts import eval_hanabi
            models = next(Path(tmp).rglob("models"))
            t1 = time.perf_counter()
            score = eval_hanabi.main(eval_hanabi.EVAL_FORWARD + [
                "--model_dir", str(models), "--eval_games", "8",
                "--device", "cuda"])
            if not 0.0 <= score <= 25.0:
                raise AssertionError(f"{name}: eval score {score}")
            log(f"  {name}: eval_hanabi (eval_hanabi_forward.sh, C++ engine) "
                f"on its checkpoint, 8 games: average score {score:.4f} in "
                f"{time.perf_counter() - t1:.2f} s")
    from onpolicy_torch.utils.tree import tree_leaves
    states = state if isinstance(state, tuple) else (state,)
    off_card = [f.name for s in states for f in dataclasses.fields(s)
                if f.name.endswith("params")
                for x in tree_leaves(getattr(s, f.name))
                if x.device.type != "cuda"]
    if off_card:
        raise AssertionError(f"{name}: parameters off the card in "
                             f"{sorted(set(off_card))}")
    host = script in HOST_SCRIPTS
    reward = ("average_score" if hanabi else "average_step_rewards" if host
              else "average_episode_rewards")
    trained = episodes - 1 if hanabi else episodes
    logged = len([r for r in history if reward in r])
    if logged != trained:
        raise AssertionError(f"{name}: {logged} episodes logged, want "
                             f"{trained}")
    if "--use_eval" in extra and not all(
            "eval_average_episode_rewards" in r for r in history):
        raise AssertionError(f"{name}: an episode without its eval")
    evals_by_episode = [r["episode"] for r in history
                        if "eval_average_episode_rewards" in r]
    if script == "train_smac" and (evals_by_episode != [0] or
                                   "eval_win_rate" not in history[0]):
        raise AssertionError(f"{name}: evals at episodes {evals_by_episode}"
                             ", want one with its win rate at episode 0")
    if script == "train_football" and evals_by_episode:
        raise AssertionError(f"{name}: train_football hands the runner no "
                             "eval env, as the JAX package's")
    for r in history:
        for k, v in r.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{name} episode {r['episode']}: "
                                     f"{k}={v}")
    if "--use_bf16" not in argv and not (ln["fwd"] and ln["bwd"]):
        raise AssertionError(f"{name}: an f32 run on the card launched the "
                             f"LayerNorm kernels fwd {ln['fwd']} bwd "
                             f"{ln['bwd']}")
    want = (fwd_per_episode * trained, bwd_per_episode * trained)
    if (fwd, bwd) != want:
        raise AssertionError(f"{name}: launches fwd={fwd} bwd={bwd}, "
                             f"want {want}")
    # the wide backward launches each of its pieces once a backward, and
    # (at the same widths) the wide forward its step kernel T times a forward
    if any(pieces.values()) and set(pieces.values()) != {bwd}:
        raise AssertionError(f"{name}: wide pieces {pieces}, backward {bwd}")
    from onpolicy_torch.config import Config
    chunk = (flag("--data_chunk_length") if "--data_chunk_length" in argv
             else Config.data_chunk_length)
    if fwd_steps != (chunk * fwd if any(pieces.values()) else 0):
        raise AssertionError(f"{name}: wide forward step launches {fwd_steps}, "
                             f"forward {fwd}, wide pieces {pieces}")
    # the runner's fps is cumulative: episode i ends at (i+1)*steps/fps_i
    ends = [(r["episode"] + 1) * steps / r["fps"] for r in history]
    # (a run that logs one row, as 2 Hanabi episodes do, has no last rate)
    last_rate = steps / (ends[-1] - ends[-2]) if len(ends) > 1 else None
    mean_rew = sum(r[reward] for r in history) / logged
    evals = [r["eval_average_episode_rewards"] for r in history
             if "eval_average_episode_rewards" in r]
    more = ""
    if host:
        more = "".join(f", {k} by episode {[round(r[k], 4) for r in history]}"
                       for k in ("incre_win_rate", "dead_ratio", "goal",
                                 "win_rate")
                       if all(k in r for r in history))
    if hanabi:
        more = (f", true steps/s {history[-1]['true_steps'] / ends[-1]:.1f} "
                f"over the run, average_score by episode "
                f"{[round(r[reward], 4) for r in history]}")
    log(f"  {name}: {threads} threads, {episodes} episodes, wall "
        f"{wall:.2f} s, launches fwd {fwd} bwd {bwd}"
        + f", LayerNorm launches fwd {ln['fwd']} bwd {ln['bwd']}"
        + (f" (wide pieces {pieces}, wide forward steps {fwd_steps})"
           if any(pieces.values()) else "")
        + ", env-steps/s "
        f"{history[-1]['fps']:.1f} over the run (first episode included), "
        + (f"{last_rate:.1f} in the last episode, " if last_rate else "")
        + f"mean {reward} {mean_rew:.4f}"
        + (f", eval returns {evals}" if evals else "") + more)
    return fwd, bwd, history[-1]["fps"], last_rate, ln


# ---------------------------------------------------------------------------
# phase 6: data parallel on the card
# ---------------------------------------------------------------------------

def dp_rank_main(out_dir, script, argv) -> int:
    """One rank of phase 6 (`chip_smoke.py --dp-rank OUT SCRIPT -- ARGV`,
    under torchrun or alone): `scripts/<script>.main(ARGV)` with the GRU
    and LayerNorm launch counts from 0; writes OUT/rank<r>.pt with the
    rank, the world size, the backend, its launches (the wide forward's
    steps and the wide backward's pieces too; the LayerNorm kernels'
    `ln_fwd`, `ln_bwd`), its logged rows and its trained
    parameters, which must lie on the device ARGV names. On a model axis
    the parameters are the kept blocks gathered after the run (on every
    rank), and the record adds the kept parameter and moment leaves, the
    same gathered, the leaf rule's dims, the model rank, and the calls
    and host ms of the run's model-group gathers (a device sync on each
    side of each)."""
    import importlib

    import torch
    sys.path.insert(0, str(ROOT))
    from onpolicy_torch.ops import cuda_gru as cg
    from onpolicy_torch.ops import cuda_layer_norm as cln
    from onpolicy_torch.parallel import distributed
    from onpolicy_torch.parallel import mesh as mesh_lib
    from onpolicy_torch.utils.tree import tree_leaves
    if script == "train_smac":
        install_engine_standins()
    module = importlib.import_module(f"onpolicy_torch.scripts.{script}")
    device = argv[argv.index("--device") + 1].split(":")[0]
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    # the trainers' `StateShards`, in the order the runner makes them (to
    # gather the kept state after the run), and every model-group gather
    # of the run, timed
    trainers, gathers = [], {"calls": 0, "ms": 0.0}
    make_shards, gather = mesh_lib.StateShards.__init__, \
        distributed.gather_model

    def record_shards(self, *args, **kwargs):
        make_shards(self, *args, **kwargs)
        trainers.append(self)

    def timed_gather(*args, **kwargs):
        sync()
        t = time.perf_counter()
        out = gather(*args, **kwargs)
        sync()
        gathers["ms"] += 1e3 * (time.perf_counter() - t)
        gathers["calls"] += 1
        return out
    mesh_lib.StateShards.__init__ = record_shards
    distributed.gather_model = timed_gather
    cg.FWD_LAUNCHES = 0
    cg.BWD_LAUNCHES = 0
    cg.FWD_STEP_LAUNCHES = 0
    cg.WIDE_LAUNCHES = dict.fromkeys(cg.WIDE_LAUNCHES, 0)
    cln.FWD_LAUNCHES = 0
    cln.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    state, history = module.main(argv)
    sync()
    wall = time.perf_counter() - t0
    launches = {"fwd": cg.FWD_LAUNCHES, "bwd": cg.BWD_LAUNCHES,
                "fwd_steps": cg.FWD_STEP_LAUNCHES,
                "wide": dict(cg.WIDE_LAUNCHES), "gathers": dict(gathers),
                "ln_fwd": cln.FWD_LAUNCHES, "ln_bwd": cln.BWD_LAUNCHES}
    states = state if isinstance(state, tuple) else (state,)
    trainers = trainers[-len(states):]
    kept = {}
    if trainers[0].on:
        full = [t.full(s) for t, s in zip(trainers, states)]

        def leaves(sts):
            return [x.detach().cpu() for s, t in zip(sts, trainers)
                    for p, o in t.fields for x in tree_leaves(
                        (getattr(s, p), getattr(s, o)["mu"],
                         getattr(s, o)["nu"]))]
        kept = {"kept": leaves(states), "full": leaves(full),
                "dims": [d for t in trainers for p, _ in t.fields
                         for d in t.layouts[p].dims * 3],
                "model_rank": trainers[0].mesh.model_rank,
                "model_size": trainers[0].mesh.model_size}
        if any(x.device.type != device for s in states
               for x in tree_leaves((s.actor_params, s.critic_params))):
            raise AssertionError(f"{script}: kept blocks off the {device}")
        states = full
    params = [x.detach() for s in states
              for x in tree_leaves((s.actor_params, s.critic_params))]
    if any(x.device.type != device for x in params):
        raise AssertionError(f"{script}: parameters off the {device}")
    rank = distributed.rank()
    backend = (torch.distributed.get_backend()
               if torch.distributed.is_initialized() else None)
    torch.save({"rank": rank, "world": distributed.world_size(),
                "backend": backend, **launches, "rows": history,
                "wall": wall, "params": [x.cpu() for x in params], **kept},
               Path(out_dir) / f"rank{rank}.pt")
    distributed.shutdown()
    return 0


def start_ranks(name, tmp, script, argv, nproc):
    """Phase 6's run `name`: `nproc` ranks under torchrun (--standalone,
    one node), or with nproc 0 one process without it, each a
    `dp_rank_main`; → (process, its run directory)."""
    run = Path(tmp) / name
    (run / "results").mkdir(parents=True)
    target = [str(ROOT / "chip_smoke.py"), "--dp-rank", str(run), script,
              "--", *argv]
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), *target] if nproc
           else [sys.executable, *target])
    env = {**os.environ, "ONPOLICY_TORCH_RESULTS": str(run / "results"),
           "PYTHONPATH": str(ROOT), "GLOO_SOCKET_IFNAME": "lo"}
    log_file = open(run / "log.txt", "w")
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=log_file,
                            stderr=subprocess.STDOUT, start_new_session=True)
    proc.log_file = log_file
    return proc, run


def stop(proc):
    """End a run of `start_ranks` and whatever is left of its session (the
    env pools' workers): SIGTERM, which torchrun passes on to its ranks,
    then SIGKILL."""
    import signal

    def signal_session(sig):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            pass
    signal_session(signal.SIGTERM)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        pass
    signal_session(signal.SIGKILL)
    proc.wait()
    if not proc.log_file.closed:
        proc.log_file.close()


def finish_ranks(name, proc, run, nproc, timeout=300):
    """Wait for a run of `start_ranks`; → its ranks' records, rank order."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    stop(proc)
    if proc.returncode != 0:
        tail = (run / "log.txt").read_text()[-4000:]
        raise AssertionError(f"{name}: exit {proc.returncode}\n{tail}")
    import torch
    records = [torch.load(run / f"rank{r}.pt", weights_only=False)
               for r in range(max(nproc, 1))]
    if [r["rank"] for r in records] != list(range(max(nproc, 1))):
        raise AssertionError(f"{name}: ranks {[r['rank'] for r in records]}")
    return records


def rel_norm_err(torch, got, want) -> float:
    """‖got − want‖ / ‖want‖ over a list of tensors."""
    num = sum(float((a.double() - b.double()).square().sum())
              for a, b in zip(got, want))
    den = sum(float(b.double().square().sum()) for b in want)
    return math.sqrt(num / max(den, 1e-30))


def check_ranks_agree(torch, name, records):
    for r in records[1:]:
        for i, (a, b) in enumerate(zip(records[0]["params"], r["params"])):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: leaf {i} differs between "
                                     f"rank 0 and rank {r['rank']}")


def check_rows(name, got, want, rtol=2e-4, atol=2e-5):
    """Every logged metric but the rate: |a − b| ≤ atol + rtol·|b|."""
    if [r["episode"] for r in got] != [r["episode"] for r in want]:
        raise AssertionError(f"{name}: logged episodes differ")
    worst = 0.0
    for g, w in zip(got, want):
        for k, v in w.items():
            if k in ("fps", "episode") or k.startswith("eval_"):
                continue
            err = abs(g[k] - v)
            if err > atol + rtol * abs(v):
                raise AssertionError(f"{name} episode {w['episode']} {k}: "
                                     f"{g[k]} against {v}")
            worst = max(worst, err / (atol + rtol * abs(v)))
    return worst


def checkpoint(run):
    """The one checkpoint directory a run wrote (rank 0), its last file."""
    import torch
    dirs = list((run / "results").rglob("models"))
    if len(dirs) != 1:
        raise AssertionError(f"{run.name}: {len(dirs)} checkpoint folders")
    last = (dirs[0] / "latest.txt").read_text().strip()
    return torch.load(dirs[0] / last, weights_only=True)


def check_against_one(torch, label, ranks, ck, one, ck_one):
    """A run of `ranks` against the one-process run `one`: the ranks'
    parameters bit for bit alike, the parameters and the checkpoint's
    state within 2e-4 of their norm, the checkpoint's carry the global
    one within 2e-4 of its norm, every logged metric at rtol 2e-4 / atol
    2e-5. → (parameters, checkpoint, carry errors, worst metric's share
    of its limit)."""
    from onpolicy_torch.utils.tree import tree_leaves as flat_tensors
    check_ranks_agree(torch, label, ranks)
    err = rel_norm_err(torch, ranks[0]["params"], one["params"])
    st = lambda c: flat_tensors(c["state"])
    if [x.shape for x in st(ck)] != [x.shape for x in st(ck_one)]:
        raise AssertionError(f"{label}: the checkpoint's state is not one "
                             "process's")
    ck_err = rel_norm_err(torch, st(ck), st(ck_one))
    if max(err, ck_err) > 2e-4:
        raise AssertionError(f"{label}: parameters {err:.3e} / checkpoint "
                             f"{ck_err:.3e} of their norm")
    carry = lambda c: flat_tensors(c["carry"])
    if [x.shape for x in carry(ck)] != [x.shape for x in carry(ck_one)]:
        raise AssertionError(f"{label}: the checkpoint's carry is not global")
    carry_err = rel_norm_err(torch, [x.float() for x in carry(ck)],
                             [x.float() for x in carry(ck_one)])
    if carry_err > 2e-4:
        raise AssertionError(f"{label}: carry {carry_err:.3e} of its norm")
    return err, ck_err, carry_err, check_rows(label, ranks[0]["rows"],
                                              one["rows"])


def check_model_axis(torch, label, ranks, M):
    """Each rank keeps only its blocks: the model rank is rank mod M; a
    parameter or moment leaf the leaf rule shards is kept as its block at
    that model rank, 1/M of it, bit for bit that block of the leaf the
    model group gathers; every rank gathers the same leaves, bit for bit;
    ranks of one model rank keep equal blocks. → (leaves sharded, leaves
    in all, floats kept over floats whole)."""
    first, by_model_rank = ranks[0], {}
    for r in ranks:
        if (r["model_rank"], r["model_size"]) != (r["rank"] % M, M):
            raise AssertionError(f"{label} rank {r['rank']}: model rank "
                                 f"{r['model_rank']} of {r['model_size']}")
        if r["dims"] != first["dims"]:
            raise AssertionError(f"{label}: layouts differ by rank")
        for i, (kept, full, d) in enumerate(zip(r["kept"], r["full"],
                                                r["dims"])):
            if not torch.equal(full, first["full"][i]):
                raise AssertionError(f"{label} rank {r['rank']}: gathered "
                                     f"leaf {i} differs from rank 0's")
            block = full if d is None else full.chunk(M, d)[r["rank"] % M]
            if kept.shape != block.shape or not torch.equal(kept, block):
                raise AssertionError(f"{label} rank {r['rank']}: kept leaf "
                                     f"{i} {tuple(kept.shape)} is not its "
                                     f"block of {tuple(full.shape)}")
        prev = by_model_rank.setdefault(r["rank"] % M, r["kept"])
        if not all(torch.equal(a, b) for a, b in zip(prev, r["kept"])):
            raise AssertionError(f"{label} rank {r['rank']}: its blocks "
                                 "differ from its model rank's")
    sharded = [i for i, d in enumerate(first["dims"]) if d is not None]
    if not sharded:
        raise AssertionError(f"{label}: no leaf sharded")
    share = (sum(first["kept"][i].numel() for i in sharded)
             / sum(first["full"][i].numel() for i in sharded))
    if abs(share * M - 1.0) > 1e-12:
        raise AssertionError(f"{label}: kept {share} of the sharded leaves")
    return len(sharded), len(first["dims"]), share


def check_launches(label, ranks, want, on_card):
    """Every rank's launch counts (`fwd`, `bwd`, `fwd_steps`, `wide`) as
    `want` gives them; on the card (every run here is f32) each rank
    launched the LayerNorm kernels both ways."""
    for r in ranks:
        got = {k: r[k] for k in want}
        if got != want:
            raise AssertionError(f"{label} rank {r['rank']}: launches {got}, "
                                 f"want {want}")
        if on_card and not (r["ln_fwd"] and r["ln_bwd"]):
            raise AssertionError(f"{label} rank {r['rank']}: LayerNorm "
                                 f"launches fwd {r['ln_fwd']} bwd "
                                 f"{r['ln_bwd']}")


def data_parallel_phase(torch, card, device="cuda"):
    """Phase 6. (a) train_mpe's flagship (128 threads, 64 a rank, hidden
    64, T=25, L=10) for 2 episodes on 2 ranks sharing the card through
    gloo, against one process without torchrun: parameters (returned
    and checkpointed) within 2e-4 of their norm, the logged metrics at
    rtol 2e-4 / atol 2e-5, the ranks' parameters bit for bit alike, the
    checkpoint's carry the global one; each rank launches the kernels 20
    times an episode at T=10 B=480 H=64. (b) the same on 1 rank of NCCL
    under torchrun: bitwise equal to the run without torchrun. (c)
    train_smac's 3s5z over the engine stand-ins at T=40, 2 ranks × 4
    envs against 1 process × 8, the same limits as (a), each rank at
    T=10 B=128. The (data, model) mesh, its ranks on gloo sharing the
    card, each run held to (a)'s limits, its ranks' kept blocks to
    `check_model_axis`: (d) the flagship at `--mesh_shape 1,2` (2 ranks,
    20 / 20 launches a rank an episode at B=480) and `2,2` (4 ranks, at
    B=240), 2 episodes; (e) the flagship at `--hidden_size 512` and
    `1,2`, 1 episode, against one process at that width: the wide kernels
    at T=10 B=480 H=512, 20 / 20 launches, 200 forward steps, 20 of each
    backward piece; (f) (c) at `1,2`. → the launches of the runs over
    ranks, by rank, grouped by the GRU shape of their kernel rows
    ("flagship" B=480, "flagship22" B=240, "wide" B=480 H=512, "smac"
    B=128). (`device` "cpu" rehearses the phase without the card, the
    kernels' launches then 0.)"""
    from onpolicy_torch.scripts import train_mpe, train_smac
    from onpolicy_torch.utils.tree import tree_leaves as flat_tensors
    episodes = 2
    flag = lambda argv, name: int(argv[len(argv) - 1 - argv[::-1].index(name)
                                       + 1])
    mpe = train_mpe.CONFIGS["flagship"]
    mpe = mpe + [
        "--num_env_steps", str(episodes * flag(mpe, "--n_rollout_threads")
                               * flag(mpe, "--episode_length")),
        "--log_interval", "1", "--experiment_name", "chip_smoke_dp",
        "--device", device]
    # (e): one episode at hidden 512 (the later flags take the place of the
    # earlier ones)
    wide = mpe + ["--hidden_size", "512", "--num_env_steps",
                  str(flag(mpe, "--n_rollout_threads")
                      * flag(mpe, "--episode_length"))]
    smac = train_smac.CONFIGS["smac_3s5z"] + ["--episode_length", "40"]
    smac = smac + [
        "--use_eval", "false", "--num_env_steps",
        str(episodes * flag(smac, "--episode_length") * 8), "--log_interval",
        "1", "--device", device]
    gloo = ["--dist_backend", "gloo"]
    on_card = device == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        # the runs that only a comparison needs go side by side; the
        # runs over ranks one at a time, for their rates and gathers
        first = [("one", "train_mpe", mpe, 0),
                 ("nccl1", "train_mpe", mpe + ["--mesh_shape", "1"], 1),
                 ("smac1", "train_smac", smac + ["--n_rollout_threads", "8"],
                  0),
                 ("one512", "train_mpe", wide, 0)]
        then = [("gloo2", "train_mpe", mpe + ["--mesh_shape", "2"] + gloo, 2),
                ("smac2", "train_smac", smac + [
                    "--n_rollout_threads", "4", "--mesh_shape", "2"] + gloo,
                 2),
                ("d12", "train_mpe", mpe + ["--mesh_shape", "1,2"] + gloo, 2),
                ("d22", "train_mpe", mpe + ["--mesh_shape", "2,2"] + gloo, 4),
                ("e12", "train_mpe", wide + ["--mesh_shape", "1,2"] + gloo,
                 2),
                ("f12", "train_smac", smac + [
                    "--n_rollout_threads", "4", "--mesh_shape", "1,2"] + gloo,
                 2)]
        procs = {}
        try:
            for n, s, a, k in first:
                procs[n] = start_ranks(n, tmp, s, a, k)
            rec = {n: finish_ranks(n, *procs[n], k) for n, _, _, k in first}
            for name, script, argv, nproc in then:
                procs[name] = start_ranks(name, tmp, script, argv, nproc)
                rec[name] = finish_ranks(name, *procs[name], nproc)
        finally:
            for proc, _ in procs.values():
                stop(proc)
        wall = time.perf_counter() - t0
        runs = {n: Path(tmp) / n for n in rec}
        ck = {n: checkpoint(runs[n]) for n in ("one", "nccl1", "gloo2",
                                               "one512", "d12", "d22",
                                               "e12")}

        # (b) NCCL at world size 1, its collectives called: bit for bit
        (n1,), (one,) = rec["nccl1"], rec["one"]
        nccl = "nccl" if on_card else "gloo"
        if (n1["backend"], n1["world"], one["backend"]) != (nccl, 1, None):
            raise AssertionError(f"(b): backend {n1['backend']} world "
                                 f"{n1['world']}, plain {one['backend']}")
        pairs = list(zip(flat_tensors(ck["nccl1"]), flat_tensors(ck["one"])))
        pairs += list(zip(n1["params"], one["params"]))
        if not all(torch.equal(a, b) if isinstance(b, torch.Tensor)
                   else a == b for a, b in pairs):
            raise AssertionError("(b): the NCCL world-size-1 run differs "
                                 "from the run without torchrun")
        drop = lambda rows: [{k: v for k, v in r.items() if k != "fps"}
                             for r in rows]
        if drop(n1["rows"]) != drop(one["rows"]) or \
                (n1["fwd"], n1["bwd"]) != (one["fwd"], one["bwd"]):
            raise AssertionError("(b): logged rows or launches differ")
        log(f"  (b) train_mpe flagship, torchrun 1 rank {nccl}: checkpoint "
            f"({len(pairs)} tensors), rows and launches bitwise equal to "
            f"the run without torchrun  ok")

        # (a) 2 ranks on gloo sharing the card
        g2 = rec["gloo2"]
        if [r["backend"] for r in g2] != ["gloo", "gloo"]:
            raise AssertionError(f"(a): backends {[r['backend'] for r in g2]}")
        err, ck_err, carry_err, worst = check_against_one(
            torch, "(a)", g2, ck["gloo2"], one, ck["one"])
        per = lambda n: n * episodes if on_card else 0
        flat_launches = {"fwd": per(20), "bwd": per(20), "fwd_steps": 0,
                         "wide": dict.fromkeys(("gates", "carry", "dw"), 0)}
        check_launches("(a)", g2, flat_launches, on_card)
        rate = g2[0]["rows"][-1]["fps"]
        log(f"  (a) train_mpe flagship, torchrun 2 ranks gloo on one card "
            f"(64 threads a rank): parameters {err:.2e} (checkpoint "
            f"{ck_err:.2e}, global carry {carry_err:.2e}) of their norm "
            f"from 1 process, metrics within {worst:.2f} of the limit, "
            f"ranks bitwise alike; GRU launches a rank an episode at T=10 "
            f"B=480 H=64: fwd {g2[0]['fwd'] // episodes} bwd "
            f"{g2[0]['bwd'] // episodes}; env-steps/s of the 2 ranks sharing "
            f"the card {rate:.1f} over the run (1 process: "
            f"{one['rows'][-1]['fps']:.1f}, run beside others) [{card}]  ok")

        # (c) the host shared runner over the stand-ins
        s2, (s1,) = rec["smac2"], rec["smac1"]
        check_ranks_agree(torch, "(c)", s2)
        serr = rel_norm_err(torch, s2[0]["params"], s1["params"])
        if serr > 2e-4:
            raise AssertionError(f"(c): parameters {serr:.3e} of their norm")
        sworst = check_rows("(c)", s2[0]["rows"], s1["rows"])
        smac_launches = {"fwd": per(10), "bwd": per(10)}
        check_launches("(c)", s2, smac_launches, on_card)
        log(f"  (c) train_smac 3s5z stand-in, T=40, torchrun 2 ranks x 4 "
            f"envs gloo against 1 process x 8: parameters {serr:.2e} of "
            f"their norm, metrics within {sworst:.2f} of the limit, ranks "
            f"bitwise alike; GRU launches a rank an episode at T=10 B=128 "
            f"H=64: fwd {s2[0]['fwd'] // episodes} bwd "
            f"{s2[0]['bwd'] // episodes}  ok")

        # (d), (e) the (data, model) mesh on train_mpe
        for name, label, ref, mesh, n_ep, want, shape in (
                ("d12", "(d) 1,2", "one", (1, 2), episodes, flat_launches,
                 "T=10 B=480 H=64"),
                ("d22", "(d) 2,2", "one", (2, 2), episodes, flat_launches,
                 "T=10 B=240 H=64"),
                ("e12", "(e) 1,2 hidden 512", "one512", (1, 2), 1,
                 {"fwd": 20 * on_card, "bwd": 20 * on_card,
                  "fwd_steps": 200 * on_card,
                  "wide": dict.fromkeys(("gates", "carry", "dw"),
                                        20 * on_card)},
                 "T=10 B=480 H=512 (wide kernels)")):
            ranks = rec[name]
            (base,) = rec[ref]
            if [r["world"] for r in ranks] != [mesh[0] * mesh[1]] * len(ranks):
                raise AssertionError(f"{label}: worlds "
                                     f"{[r['world'] for r in ranks]}")
            err, ck_err, carry_err, worst = check_against_one(
                torch, label, ranks, ck[name], base, ck[ref])
            n_sharded, n_leaves, share = check_model_axis(torch, label, ranks,
                                                          mesh[1])
            check_launches(label, ranks, want, on_card)
            if name == "d12":
                # the same rows and sums as (a); only the layout differs
                same = all(torch.equal(a, b) for a, b in zip(
                    ranks[0]["params"], g2[0]["params"]))
                log(f"  (d) 1,2: parameters bit for bit (a)'s: {same}")
            g = ranks[0]["gathers"]
            log(f"  {label}: torchrun {len(ranks)} ranks gloo on one card, "
                f"{n_ep} episode(s): parameters {err:.2e} (checkpoint "
                f"{ck_err:.2e}, global carry {carry_err:.2e}) of their norm "
                f"from 1 process, metrics within {worst:.2f} of the limit, "
                f"gathered parameters bitwise alike on every rank; each rank "
                f"keeps its block of {n_sharded} of {n_leaves} parameter and "
                f"moment leaves ({share:.4f} of their floats), bitwise the "
                f"model group's gather; GRU launches a rank an episode at "
                f"{shape}: fwd {ranks[0]['fwd'] // n_ep} bwd "
                f"{ranks[0]['bwd'] // n_ep} (wide forward steps "
                f"{ranks[0]['fwd_steps'] // n_ep}, wide pieces "
                f"{ {k: v // n_ep for k, v in ranks[0]['wide'].items()} }); "
                f"model-group gathers of rank 0 an episode: "
                f"{g['calls'] / n_ep:.1f} calls, {g['ms'] / n_ep:.3f} ms "
                f"(host clock, device synced) [{card}]; env-steps/s of the "
                f"ranks sharing the card {ranks[0]['rows'][-1]['fps']:.1f} "
                f"over the run  ok")

        # (f) the host shared runner at 1,2
        f2 = rec["f12"]
        check_ranks_agree(torch, "(f)", f2)
        ferr = rel_norm_err(torch, f2[0]["params"], s1["params"])
        if ferr > 2e-4:
            raise AssertionError(f"(f): parameters {ferr:.3e} of their norm")
        fworst = check_rows("(f)", f2[0]["rows"], s1["rows"])
        f_sharded, f_leaves, f_share = check_model_axis(torch, "(f)", f2, 2)
        check_launches("(f)", f2, smac_launches, on_card)
        g = f2[0]["gathers"]
        log(f"  (f) train_smac 3s5z stand-in, T=40, torchrun 2 ranks x 4 "
            f"envs gloo at --mesh_shape 1,2 against 1 process x 8: "
            f"parameters {ferr:.2e} of their norm, metrics within "
            f"{fworst:.2f} of the limit, gathered parameters bitwise alike; "
            f"each rank keeps its block of {f_sharded} of {f_leaves} leaves "
            f"({f_share:.4f} of their floats); GRU launches a rank an "
            f"episode at T=10 B=128 H=64: fwd {f2[0]['fwd'] // episodes} "
            f"bwd {f2[0]['bwd'] // episodes}; model-group gathers of rank 0 "
            f"an episode: {g['calls'] / episodes:.1f} calls, "
            f"{g['ms'] / episodes:.3f} ms [{card}]  ok")
        log(f"  phase 6 wall {wall:.1f} s")
    by_rank = lambda run, name: {f"{run} rank {r['rank']}": {
        "fwd": r["fwd"], "bwd": r["bwd"], "ln_fwd": r["ln_fwd"],
        "ln_bwd": r["ln_bwd"]} for r in rec[name]}
    return {"flagship": {**by_rank("dp flagship", "gloo2"),
                         **by_rank("dp 1,2 flagship", "d12")},
            "flagship22": by_rank("dp 2,2 flagship", "d22"),
            "wide": by_rank("dp 1,2 flagship H=512", "e12"),
            "smac": {**by_rank("dp smac_3s5z", "smac2"),
                     **by_rank("dp 1,2 smac_3s5z", "f12")}}


# ---------------------------------------------------------------------------
# phase 7: rendering
# ---------------------------------------------------------------------------

# render_mpe on the flagship's policy (simple_spread, 3 agents, T=25), and
# render_football on render_football.sh's flags, 1 episode (no
# --save_videos: the card's machine may have no imageio)
RENDER_MPE = ["--env_name", "MPE", "--algorithm_name", "rmappo",
              "--scenario_name", "simple_spread", "--num_agents", "3",
              "--num_landmarks", "3", "--seed", "1", "--episode_length", "25",
              "--render_episodes", "2", "--use_ReLU", "false", "--gain",
              "0.01"]
RENDER_FOOTBALL = ["--env_name", "Football", "--scenario_name",
                   "academy_3_vs_1_with_keeper", "--algorithm_name", "rmappo",
                   "--experiment_name", "render", "--seed", "1",
                   "--num_agents", "3", "--representation", "simple115v2",
                   "--use_render", "--render_episodes", "1",
                   "--n_rollout_threads", "1"]


def _off_card(state, device):
    from onpolicy_torch.utils.tree import tree_leaves
    return [x for x in tree_leaves((state.actor_params, state.critic_params))
            if x.device.type != device]


def _same_episodes(name, got, want, rtol=1e-5):
    """Card against CPU: each episode's actions equal, its reward within
    `rtol` relative."""
    (rew, acts), (rew_cpu, acts_cpu) = got, want
    for e, (a, b) in enumerate(zip(acts, acts_cpu)):
        if a.shape != b.shape or not bool((a.cpu() == b).all()):
            raise AssertionError(f"{name} episode {e}: the card's actions "
                                 "differ from the CPU's")
    for e, (a, b) in enumerate(zip(rew, rew_cpu)):
        if not math.isfinite(a) or abs(a - b) > rtol * abs(b):
            raise AssertionError(f"{name} episode {e}: reward {a!r} on the "
                                 f"card, {b!r} on the CPU")


def render_phase(torch, cg, device="cuda"):
    """Phase 7. (a) Whether matplotlib and imageio import (a subprocess).
    (b) `scripts/render_mpe`'s loop on the flagship's policy, 2 episodes
    of 25 steps, from one checkpoint (written by `utils/checkpoint.save`
    from a seeded state) restored on the card and on the CPU, the same
    first worlds injected into both: the card's actions equal the CPU's
    at every step, the episode rewards within 1e-5 relative, every
    parameter on the card, no GRU kernel launched (the loop acts through
    the single-step cell); with (a), a frame drawn after the reset and
    after each step (26 an episode) and the gifs written to a temporary
    directory. (c) `scripts/render_football`'s loop over the GRF engine
    stand-in, 1 episode, card against CPU from one checkpoint: the same
    actions and reward. (`device` "cpu" rehearses the phase without the
    card.)"""
    from onpolicy_torch.envs.football.football_env import FootballEnv
    from onpolicy_torch.envs.mpe.world import WorldState
    from onpolicy_torch.scripts import render_football, render_mpe
    from onpolicy_torch.utils import checkpoint as ckpt
    from onpolicy_torch.utils.render import render_frame

    probe = subprocess.run([sys.executable, "-c", "import matplotlib, imageio"],
                           capture_output=True, text=True)
    draws = probe.returncode == 0
    log("  matplotlib and imageio: " + (
        "import" if draws else f"missing ({probe.stderr.strip()}): no frame "
        "is drawn on this machine"))

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (b) render_mpe
        cfg_of = lambda on, *more: render_mpe.config_from_args(
            RENDER_MPE + ["--device", on, *more], n_rollout_threads=1,
            use_render=True)
        runner, state = render_mpe.load_policy(cfg_of("cpu", "--seed", "7"))
        ckpt.save(tmp / "mpe", state, 0, {})
        env = runner.envs.env
        resets = [env.reset(1, torch.Generator().manual_seed(100 + e),
                            "cpu")[0] for e in range(2)]
        runs, frames = {}, []

        def frame(spec, world):
            frames.append(render_frame(spec, world))
            return frames[-1]
        for card in (True, False):
            on = device if card else "cpu"
            more = ["--model_dir", str(tmp / "mpe")]
            if card and draws:
                more.append("--save_gifs")
            runner, state = render_mpe.load_policy(cfg_of(on, *more))
            if _off_card(state, on):
                raise AssertionError("render_mpe: parameters off the card")
            starts = []

            def reset(ep, on=on):
                starts.append(time.perf_counter())
                return WorldState.from_tensors(
                    {k: v.to(on) for k, v in resets[ep].tensors().items()})
            cg.FWD_LAUNCHES = cg.BWD_LAUNCHES = 0
            runs[card] = render_mpe.render_episodes(
                runner, state, frame if card and draws else None, reset,
                tmp / "gifs")
            if card:
                starts.append(time.perf_counter())
                launches = (cg.FWD_LAUNCHES, cg.BWD_LAUNCHES)
                ms = [1e3 * (b - a) for a, b in zip(starts, starts[1:])]
        _same_episodes("render_mpe", runs[True], runs[False])
        if launches != (0, 0):
            raise AssertionError(f"render_mpe launched GRU kernels {launches}")
        gifs = sorted(p.name for p in (tmp / "gifs").glob("*.gif"))
        if draws and (len(frames) != 2 * 26 or len(gifs) != 2):
            raise AssertionError(f"render_mpe: {len(frames)} frames, gifs "
                                 f"{gifs}; want 26 an episode, 2 gifs")
        log(f"  render_mpe (simple_spread, 3 agents, 2 episodes of 25 steps, "
            f"seeded checkpoint): actions equal to the CPU's at every step, "
            f"episode rewards {runs[True][0]} on the card, "
            f"{runs[False][0]} on the CPU; GRU launches {launches}; ms an "
            f"episode on the card {ms} "
            + (f"with {len(frames)} frames drawn (26 an episode) and gifs "
               f"{gifs} written to a temporary directory" if draws else
               "(no frame drawn on the card: no matplotlib / imageio)")
            + "  ok")

        # (c) render_football over the engine stand-in
        install_engine_standins()
        # parameters from seed 33 play a 78-step episode on the stand-in
        # (from many seeds the policy shoots or loses the ball at once)
        _, cfg = render_football.config_from_args(RENDER_FOOTBALL + [
            "--device", "cpu", "--seed", "33"])
        _, state = render_football.load_policy(
            cfg, FootballEnv(num_agents=cfg.num_agents))
        ckpt.save(tmp / "football", state, 0, {})
        runs = {}
        for card in (True, False):
            on = device if card else "cpu"
            ns, cfg = render_football.config_from_args(RENDER_FOOTBALL + [
                "--device", on, "--model_dir", str(tmp / "football")])
            env = FootballEnv(scenario_name=cfg.scenario_name,
                              num_agents=cfg.num_agents,
                              representation=ns.representation,
                              rewards=ns.rewards, use_render=True,
                              seed=cfg.seed)
            algo, state = render_football.load_policy(cfg, env)
            if _off_card(state, on):
                raise AssertionError("render_football: parameters off the "
                                     "card")
            cg.FWD_LAUNCHES = cg.BWD_LAUNCHES = 0
            t0 = time.perf_counter()
            runs[card] = render_football.render_episodes(algo, state, env,
                                                         cfg)
            if card:
                football_ms = 1e3 * (time.perf_counter() - t0)
                launches = (cg.FWD_LAUNCHES, cg.BWD_LAUNCHES)
            env.close()
        _same_episodes("render_football", runs[True], runs[False])
        if launches != (0, 0):
            raise AssertionError(f"render_football launched GRU kernels "
                                 f"{launches}")
        steps = len(runs[True][1][0])
        log(f"  render_football (render_football.sh's flags, GRF stand-in, 1 "
            f"episode of {steps} steps, seeded checkpoint): actions equal to "
            f"the CPU's, reward {runs[True][0]} on the card, "
            f"{runs[False][0]} on the CPU; GRU launches {launches}; "
            f"{football_ms:.2f} ms an episode on the card  ok")


def kernel_rows(times, launches, errs, shape, streams):
    """The `kernels` line's rows of both kernels for one stream type;
    `launches` maps each run of that stream type to its counts, and a
    row's `launches` is their sum. `bound_ms` is the best the card can do
    for the function, whichever variant ran: the products in 3xTF32 passes
    on the tensor cores, which hold f32 accuracy. `bound_f32_ms` keeps the
    bound on the f32 CUDA cores beside it."""
    src = "onpolicy_torch/csrc/gru_seq.cu"
    rows = []
    for d, name, line in (("fwd", "gru_seq_fwd", 122),
                          ("bwd", "gru_seq_bwd", 219)):
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"onpolicy_tpu/ops/pallas_gru.py:{line}",
            "streams": streams, "shape": shape,
            "variant": times[f"{d}_variant"],
            "launches": sum(n[d] for n in launches.values()),
            "launches_by_run": {
                k: {"launches": n[d],
                    "gru_shapes": {**RUN_GRU_SHAPES, **DP_GRU_SHAPES}.get(
                        k, "no GRU kernel")}
                for k, n in launches.items()},
            "max_abs_err": errs[d],
            "ms": times[f"{d}_ms"], "device_ms": times[f"{d}_device_ms"],
            "plain_ms": times[f"{d}_plain_ms"],
            "bound_ms": times[f"{d}_bound_tc_ms"],
            "bound_by": times[f"{d}_bound_tc_by"],
            "bound_f32_ms": times[f"{d}_bound_f32_ms"],
            "bound_f32_by": times[f"{d}_bound_f32_by"],
            "library_ms": times[f"{d}_library_ms"]})
        if f"{d}_device_ms_by_kernel" in times:
            rows[-1]["device_ms_by_kernel"] = times[f"{d}_device_ms_by_kernel"]
    return rows


def main() -> int:
    if not (ROOT / "onpolicy_torch" / "csrc" / "gru_seq.cu").exists():
        print("chip_smoke.py: the onpolicy_torch package is not beside this "
              "script; run it from the root of the repository",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-rank"]:
        # one rank of phase 6: OUT SCRIPT -- ARGV
        return dp_rank_main(sys.argv[2], sys.argv[3], sys.argv[5:])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from onpolicy_torch.ops import cuda_gru as cg

    log("== 1. card")
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("== 2. build")
    t0 = time.perf_counter()
    lib = cg.build()
    log(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    log(lib.with_suffix(".ptxas.txt").read_text().strip())

    errs = {}
    for stream_dtype in (None, torch.bfloat16):
        streams = "bf16" if stream_dtype is not None else "f32"
        log(f"== 3. kernels against their plain versions ({streams} streams)")
        itemsize = 2 if stream_dtype is not None else 4
        for walk in (cg.device_fwd_plan(torch.device("cuda"), 5003, 64,
                                        itemsize),
                     cg.device_bwd_plan(torch.device("cuda"), 5003, 64,
                                        itemsize)):
            if -(-5003 // walk.bt) <= walk.grid:
                raise AssertionError(f"B=5003: {walk} walks no second tile")
        for case, T, B, H, opts in SHAPES:
            errs[case, streams] = check_layer(
                torch, cg, case, T, B, H, stream_dtype=stream_dtype, **opts)
        check_sequence_layers(torch, cg, stream_dtype)
    log("== 3. kernels against their plain versions at the Hanabi width "
        "(f32 streams)")
    for case, T, B, H, opts in HANABI_SHAPES:
        errs[case, "f32"] = check_layer(torch, cg, case, T, B, H, **opts)
    check_sequence_layers(torch, cg, None, H=512)
    log("== 3. kernels against their plain versions at the host runners' "
        "shapes (f32 streams)")
    for case, T, B, H, opts in HOST_SHAPES:
        errs[case, "f32"] = check_layer(torch, cg, case, T, B, H, **opts)
    log("== 3. kernels against their plain versions at a data-parallel "
        "rank's shapes (f32 streams)")
    for case, shape in (("dp flagship rank", DP_FLAGSHIP),
                        ("dp smac_3s5z rank", DP_SMAC),
                        ("dp 2,2 flagship rank", DP22_FLAGSHIP),
                        ("dp 1,2 flagship H=512 rank", DP_WIDE)):
        errs[case, "f32"] = check_layer(torch, cg, case, *shape.values(),
                                        repeat=True)

    log("== 4. times (CUDA events)")
    t_flag = time_shape(torch, cg, FLAGSHIP, card)
    time_shape(torch, cg, BENCH, card)
    time_shape(torch, cg, FLAGSHIP, card, torch.bfloat16)
    t_bench16 = time_shape(torch, cg, BENCH, card, torch.bfloat16)
    compare_forwards(torch, cg, FLAGSHIP, card)
    compare_forwards(torch, cg, BENCH, card)
    t_hanabi = time_shape(torch, cg, HANABI, card)
    compare_forwards(torch, cg, HANABI, card)
    compare_backwards(torch, cg, HANABI, card)
    t_smac = time_shape(torch, cg, SMAC, card)
    t_dp = time_shape(torch, cg, DP_FLAGSHIP, card)
    t_dp_smac = time_shape(torch, cg, DP_SMAC, card)
    t_dp22 = time_shape(torch, cg, DP22_FLAGSHIP, card)
    t_dp_wide = time_shape(torch, cg, DP_WIDE, card)
    ln_rows = time_layer_norm(torch, card)

    log("== 5. main path: train_mpe, train_hanabi, train_smac and "
        "train_football configurations")
    check_small_against_cpu(torch, "rmappo f32", (1e-3, 1e-4), 1e-3,
                            algorithm_name="rmappo")
    check_small_against_cpu(torch, "rmappo bf16", (5e-2, 5e-2), 0.25,
                            algorithm_name="rmappo", use_bf16=True)
    check_small_against_cpu(torch, "mappo dedup bf16", (5e-2, 5e-2), 0.25,
                            algorithm_name="mappo", use_bf16=True,
                            use_critic_dedup=True)
    # the dedup path in f32, at the f32 limits: what the bf16 reading above
    # owes to the dedup path and what to bf16 rounding
    check_small_against_cpu(torch, "mappo dedup f32", (1e-3, 1e-4), 1e-3,
                            algorithm_name="mappo", use_critic_dedup=True)
    check_small_against_cpu(torch, "happo f32 (3 agents)", (1e-3, 1e-4),
                            1e-3, algorithm_name="happo")
    check_small_against_cpu(torch, "mat f32", (1e-3, 1e-4), 1e-3,
                            algorithm_name="mat")
    check_small_against_cpu(torch, "mat_dec f32", (1e-3, 1e-4), 1e-3,
                            algorithm_name="mat_dec")
    f0, b0 = cg.FWD_LAUNCHES, cg.BWD_LAUNCHES
    check_small_against_cpu(torch, "hatrpo f32 (3 agents)", (1e-3, 1e-4),
                            1e-3, algorithm_name="hatrpo")
    if (cg.FWD_LAUNCHES, cg.BWD_LAUNCHES) != (f0, b0):
        raise AssertionError("hatrpo launched a GRU kernel")
    log("  mat, mat_dec and hatrpo launch no GRU kernel: MAT has no GRU, "
        "and HATRPO's Fisher-vector product differentiates the GRU twice, "
        "which the kernels' backward refuses, so its GRU runs as the plain "
        "scan on the card, as the JAX package routes it")
    # PopArt in place of ValueNorm, and the 6 agents of simple_world_comm
    # through the separated runner; then the new heads and the CNN base,
    # and every new scenario with the world's walls and noise
    check_small_against_cpu(torch, "rmappo popart f32", (1e-3, 1e-4), 1e-3,
                            algorithm_name="rmappo", use_popart=True,
                            use_valuenorm=False)
    check_small_against_cpu(torch, "rmappo world_comm f32 (6 agents)",
                            (1e-3, 1e-4), 1e-3, algorithm_name="rmappo",
                            **WORLD_COMM)
    check_models_against_cpu(torch, cg)
    check_scenarios_against_cpu(torch)
    # the device engine at H=128 (the CUDA-core kernels carry its update)
    check_hanabi_against_cpu(torch, cg, "hanabi rmappo f32 H=128 (device "
                             "engine, decks injected)", HANABI_DEVICE_CHECK)
    # the C++ engine through the host seat loop, train_hanabi_forward.sh's
    # path, feed-forward and recurrent (the tensor-core kernels at H=32)
    for algo in ("mappo", "rmappo"):
        check_hanabi_against_cpu(
            torch, cg, f"hanabi {algo} f32 H=32 (C++ engine, host seat loop)",
            HANABI_HOST_CHECK + ["--algorithm_name", algo])
    # the host runners over the engine stand-ins (SMAC, SMACv2)
    install_engine_standins()
    for name, config in HOST_CHECKS:
        check_host_against_cpu(torch, cg, name, config)
    # each run's launches go to the kernel rows of its GRU shape
    launches = {"f32": {}, "bf16": {}, "hanabi": {}, "smac": {}}
    ln_launches = {}
    for name, script, config, extra, episodes, fwd_pe, bwd_pe in TRAIN_RUNS:
        fwd, bwd, _, _, ln_launches[name] = train_main_path(
            torch, cg, name, script, config, extra, episodes, fwd_pe, bwd_pe,
            evaluate=name == "hanabi_forward")
        shape = ("bf16" if config.startswith("bench")
                 else "hanabi" if script == "train_hanabi"
                 else "smac" if script in HOST_SCRIPTS else "f32")
        launches[shape][name] = {"fwd": fwd, "bwd": bwd}
    from onpolicy_torch.scripts import profile_episode
    prof = profile_episode.main(["--config", "hanabi_forward", "--episodes",
                                 "2", "--warmup", "1"])
    log(f"  hanabi_forward episodes on the card: rollout ms "
        f"{prof['rollout_ms']} (100 host seat rounds on the C++ engine), "
        f"update ms {prof['update_ms']}, device idle share "
        f"{prof['device_idle_share']:.3f}, kernel launches an episode "
        f"{prof['kernel_launches']}")
    # the host runners over the worker pool and the stand-ins installed above
    for config in ("smac_3s5z", "football_3v1"):
        prof = profile_episode.main(["--config", config, "--episodes", "2",
                                     "--warmup", "1"])
        log(f"  {config} episodes on the card: rollout ms "
            f"{prof['rollout_ms']}, update ms {prof['update_ms']}, "
            f"device idle share {prof['device_idle_share']:.3f}, kernel "
            f"launches an episode {prof['kernel_launches']} (host-to-device "
            f"copies {prof['h2d_copies']}, GRU {prof['gru_kernel_launches']})")

    log("== 6. data parallel on the card: torchrun, 2 ranks sharing it on "
        "gloo, 1 rank on NCCL; the (data, model) mesh at 1,2 and 2,2")
    dp = data_parallel_phase(torch, card)

    log("== 7. render: render_mpe and render_football, card against CPU")
    t0 = time.perf_counter()
    render_phase(torch, cg)
    log(f"  phase 7 wall {time.perf_counter() - t0:.1f} s")

    row_errs = lambda case, streams: dict(zip(("fwd", "bwd"),
                                              errs[case, streams]))
    kernels = kernel_rows(t_flag, launches["f32"],
                          row_errs("flagship", "f32"), FLAGSHIP, "f32")
    kernels += kernel_rows(t_bench16, launches["bf16"],
                           row_errs("bench (16384 threads)", "bf16"), BENCH,
                           "bf16")
    kernels += kernel_rows(t_hanabi, launches["hanabi"],
                           row_errs("Hanabi T=10 B=20000 H=512", "f32"), HANABI,
                           "f32")
    kernels += kernel_rows(t_smac, launches["smac"],
                           row_errs("SMAC 3s5z T=10 B=2560", "f32"), SMAC,
                           "f32")
    for times, group, case, shape in (
            (t_dp, "flagship", "dp flagship rank", DP_FLAGSHIP),
            (t_dp_smac, "smac", "dp smac_3s5z rank", DP_SMAC),
            (t_dp22, "flagship22", "dp 2,2 flagship rank", DP22_FLAGSHIP),
            (t_dp_wide, "wide", "dp 1,2 flagship H=512 rank", DP_WIDE)):
        kernels += kernel_rows(times, dp[group], row_errs(case, "f32"),
                               shape, "f32")
    # the LayerNorm rows carry every run's launches of their kernel (at the
    # run's own widths and rows, not the row's shape)
    for group in dp.values():
        ln_launches.update({k: {"fwd": n["ln_fwd"], "bwd": n["ln_bwd"]}
                            for k, n in group.items()})
    for row in ln_rows:
        d = "fwd" if row["name"] == "ln_fwd" else "bwd"
        row["launches"] = sum(n[d] for n in ln_launches.values())
        row["launches_by_run"] = {k: n[d] for k, n in ln_launches.items()}
    kernels += ln_rows
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
