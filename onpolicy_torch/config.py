"""Typed configuration tree of the PyTorch port.

The port's own copy of `onpolicy_tpu/config.py` (the port imports nothing
from the JAX package): the same frozen dataclass with the reference's
defaults, the same algorithm-name canonicalization and the same strict
argparse bridge (unknown flags raise). Added: `device`, which defaults to
the card, and `dist_backend`, the process group's backend of a
data-parallel run (`parallel/distributed.py`: None takes nccl on the card
and gloo on the CPU). `validate()` raises when CUDA is asked for and
there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Config:
    # ---- prepare ----
    algorithm_name: str = "mappo"  # mappo|rmappo|ippo|happo|hatrpo|mat|mat_dec
    experiment_name: str = "check"
    seed: int = 1
    n_training_threads: int = 1
    n_rollout_threads: int = 32          # parallel env instances
    n_eval_rollout_threads: int = 1
    n_render_rollout_threads: int = 1
    num_env_steps: int = 10_000_000
    user_name: str = "onpolicy_torch"
    use_wandb: bool = False

    # ---- env ----
    env_name: str = "MPE"
    scenario_name: str = "simple_spread"
    num_agents: int = 3
    num_landmarks: int = 3
    num_good_agents: int = 1
    num_adversaries: int = 3
    use_obs_instead_of_state: bool = False

    # ---- replay buffer ----
    episode_length: int = 200

    # ---- network ----
    share_policy: bool = True
    use_centralized_V: bool = True
    stacked_frames: int = 1
    use_stacked_frames: bool = False
    hidden_size: int = 64
    layer_N: int = 1
    use_ReLU: bool = True
    use_popart: bool = False
    use_valuenorm: bool = True
    use_feature_normalization: bool = True
    use_orthogonal: bool = True
    gain: float = 0.01

    # ---- recurrent policy ----
    use_naive_recurrent_policy: bool = False
    use_recurrent_policy: bool = True
    recurrent_N: int = 1
    data_chunk_length: int = 10
    # Sequence-mode GRU through the CUDA kernels (ops/cuda_gru.py).
    # None: the kernels for tensors on the card, the plain scan for
    # tensors on the CPU, and the plain scan for hatrpo on both (its
    # double backward, models/gru.py). True asks for the kernels (refused
    # on the CPU); False asks for the plain scan (refused on the card but
    # for hatrpo).
    use_pallas_gru: Optional[bool] = None
    # Hanabi: `use_jax_env` runs the device-resident engine (in the port a
    # tensor engine, envs/hanabi/torch_engine.py; the flag keeps its name so
    # the launch scripts run unchanged), else the C++ engine; either
    # collect flag runs the device round loop, neither the host seat loop
    # (runner/hanabi_runner.py)
    use_device_collect: bool = False
    use_scan_rounds: bool = False
    use_jax_env: bool = False
    # bf16 mixed precision: the MLP and GRU compute in bf16, the GRU
    # kernels move their [T, B, H] streams in bf16 (models/common.py)
    use_bf16: bool = False
    # feed-forward shared mappo: the critic runs once per env row
    use_critic_dedup: bool = False

    # ---- optimizer ----
    lr: float = 5e-4
    critic_lr: float = 5e-4
    opti_eps: float = 1e-5
    weight_decay: float = 0.0

    # ---- trpo (HATRPO) ----
    kl_threshold: float = 0.01
    ls_step: int = 10
    accept_ratio: float = 0.5

    # ---- ppo ----
    ppo_epoch: int = 15
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    num_mini_batch: int = 1
    entropy_coef: float = 0.01
    value_loss_coef: float = 1.0
    use_max_grad_norm: bool = True
    max_grad_norm: float = 10.0
    use_gae: bool = True
    gamma: float = 0.99
    gae_lambda: float = 0.95
    use_proper_time_limits: bool = False
    use_huber_loss: bool = True
    use_value_active_masks: bool = True
    use_policy_active_masks: bool = True
    huber_delta: float = 10.0

    # ---- run ----
    use_linear_lr_decay: bool = False

    # ---- save / log ----
    save_interval: int = 1
    log_interval: int = 5
    model_dir: Optional[str] = None

    # ---- eval / render ----
    use_eval: bool = False
    eval_interval: int = 25
    eval_episodes: int = 32
    save_gifs: bool = False
    use_render: bool = False
    render_episodes: int = 5
    ifi: float = 0.1

    # ---- MAT / transformer ----
    n_block: int = 1
    n_embd: int = 64
    n_head: int = 1
    dec_actor: bool = False
    share_actor: bool = False
    encode_state: bool = False

    # ---- device and run layout ----
    mesh_shape: Tuple[int, ...] = (1,)
    profile_dir: Optional[str] = None
    episodes_per_call: int = 1
    device: str = "cuda"                 # "cuda", "cuda:<i>" or "cpu"
    dist_backend: Optional[str] = None   # "nccl" | "gloo" (None: by device)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    # -- derived / validation ----------------------------------------
    def validate(self) -> "Config":
        if self.use_popart and self.use_valuenorm:
            raise ValueError("use_popart and use_valuenorm are exclusive")
        if self.algorithm_name in ("rmappo", "happo", "hatrpo"):
            if not (self.use_recurrent_policy or self.use_naive_recurrent_policy):
                raise ValueError(f"{self.algorithm_name} expects a recurrent policy")
        total_batch = self.episode_length * self.n_rollout_threads
        if total_batch % self.num_mini_batch != 0:
            raise ValueError(
                f"episode_length*n_rollout_threads={total_batch} not divisible "
                f"by num_mini_batch={self.num_mini_batch}")
        if self.use_critic_dedup:
            if not (self.share_policy and self.use_centralized_V):
                raise ValueError("use_critic_dedup requires share_policy "
                                 "and use_centralized_V (the dedup relies "
                                 "on an agent-invariant share_obs)")
            if self.is_recurrent:
                raise ValueError("use_critic_dedup supports feed-forward "
                                 "policies only")
            if self.algorithm_name != "mappo":
                raise ValueError("use_critic_dedup supports the shared "
                                 "mappo trainer only")
            if self.num_mini_batch != 1:
                raise ValueError("use_critic_dedup requires num_mini_batch=1")
            if self.env_name in ("Hanabi", "StarCraft2", "SMAC",
                                 "StarCraft2v2", "SMACv2"):
                raise ValueError(
                    f"use_critic_dedup is invalid for {self.env_name}")
        self._validate_device()
        return self

    def _validate_device(self):
        import torch
        kind = self.device.split(":")[0]
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda[:i] or cpu, not "
                             f"{self.device!r}")
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device={self.device!r} but torch.cuda.is_available() is "
                "false; pass --device cpu to run on the CPU")
        if kind == "cpu" and self.use_pallas_gru:
            raise ValueError("use_pallas_gru=True needs device cuda: the "
                             "GRU kernels run on the card only")
        if (kind == "cuda" and self.use_pallas_gru is False
                and self.algorithm_name != "hatrpo"):
            raise ValueError("use_pallas_gru=False asks for the plain GRU "
                             "scan, which is the CPU path; on the card the "
                             "sequence GRU always runs the kernels")

    @property
    def is_recurrent(self) -> bool:
        return self.use_recurrent_policy or self.use_naive_recurrent_policy


def canonicalize_algorithm(cfg: Config) -> Config:
    """Algorithm-name → flag canonicalization (the reference's
    `scripts/train/train_mpe.py:68-80`): rmappo ⇒ recurrent, mappo/mat ⇒
    feed-forward, ippo ⇒ decentralized V, mat_dec ⇒ dec_actor."""
    name = cfg.algorithm_name
    if name == "rmappo":
        cfg = cfg.replace(use_recurrent_policy=True, use_naive_recurrent_policy=False)
    elif name in ("mappo", "mat", "mat_dec"):
        cfg = cfg.replace(use_recurrent_policy=False, use_naive_recurrent_policy=False)
    elif name == "ippo":
        cfg = cfg.replace(use_centralized_V=False)
    elif name in ("happo", "hatrpo"):
        cfg = cfg.replace(share_policy=False)
    else:
        raise ValueError(f"unknown algorithm {name!r}")
    if name == "mat_dec":
        cfg = cfg.replace(dec_actor=True, share_actor=True)
    return cfg


_BOOL_FIELDS = {
    f.name for f in dataclasses.fields(Config)
    if f.type in ("bool", bool, "Optional[bool]")
}


def get_config() -> argparse.ArgumentParser:
    """An ArgumentParser whose flags mirror the Config fields. Booleans
    accept an optional explicit value (`--use_popart`, `--use_popart
    false`); everything else is typed from the dataclass default."""
    p = argparse.ArgumentParser("onpolicy_torch", allow_abbrev=False)
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.name in _BOOL_FIELDS:
            p.add_argument(name, nargs="?", const=True, default=default,
                           type=_parse_bool)
        elif f.name == "mesh_shape":
            p.add_argument(name, type=_parse_ints, default=default)
        elif f.type in ("Optional[str]",):
            p.add_argument(name, type=str, default=default)
        else:
            p.add_argument(name, type=type(default) if default is not None else str,
                           default=default)
    return p


def _parse_bool(s):
    if isinstance(s, bool):
        return s
    return s.lower() in ("1", "true", "yes", "on")


def _parse_ints(s):
    return tuple(int(x) for x in s.split(","))


def apply_wandb_sweep(cfg: Config) -> Config:
    """wandb sweep parity: when use_wandb is on and a wandb run is active
    (a sweep agent launched us), the run's config values override the
    parsed flags. Unknown keys raise, matching the strict parser."""
    if not cfg.use_wandb:
        return cfg
    try:
        import wandb
    except ImportError:
        return cfg
    import os
    run = getattr(wandb, "run", None)
    if run is None and os.environ.get("WANDB_SWEEP_ID"):
        run = wandb.init()
    if run is None or getattr(run, "config", None) is None:
        return cfg
    updates = {}
    for k, v in dict(run.config).items():
        if k not in Config.__dataclass_fields__:
            raise ValueError(f"unknown wandb sweep parameter: {k}")
        updates[k] = _coerce_sweep_value(k, v)
    return cfg.replace(**updates) if updates else cfg


def _coerce_sweep_value(name, value):
    """Route raw yaml/string sweep values through the CLI coercers so the
    frozen-config invariants hold (real bools, int tuples)."""
    if name in _BOOL_FIELDS:
        return _parse_bool(value)
    if name == "mesh_shape":
        return _parse_ints(value) if isinstance(value, str) \
            else tuple(int(x) for x in value)
    default = Config.__dataclass_fields__[name].default
    if default is dataclasses.MISSING or default is None:
        return value
    if isinstance(default, int) and not isinstance(default, bool) \
            and isinstance(value, (str, int, float)):
        return int(float(value))
    if isinstance(default, float) and isinstance(value, (str, int, float)):
        return float(value)
    if isinstance(value, str):
        return type(default)(value)
    return value


def config_from_args(argv=None, **overrides) -> Config:
    ns = get_config().parse_args(argv)
    cfg = Config(**vars(ns)).replace(**overrides)
    return canonicalize_algorithm(apply_wandb_sweep(cfg)).validate()
