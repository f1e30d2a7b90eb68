"""Batched MPE environment with lockstep auto-reset.

Port of `onpolicy_tpu/envs/mpe/env.py`. The JAX `MPEEnv` steps one
instance and `MPEVecEnv` vmaps it; here `MPEEnv` is written over a batch
of N worlds and `MPEVecEnv` adds the auto-reset and the env's own
`torch.Generator`.

Semantics kept:
  * discrete action decoding via one-hot difference: u=[a₁−a₂, a₃−a₄]
    scaled by sensitivity (accel or 5.0);
  * comm one-hot c[comm_idx]=1 for non-silent agents;
  * cooperative reward = sum over agents broadcast to all;
  * an episode ends when the step count reaches world_length; auto-reset
    returns the fresh obs with the terminal step's rewards/dones.

Actions arrive in storage format: integer indices [N, M, n_heads].
A world with action or comm noise (`world.has_noise`) takes standard
normal draws each step: from the vec env's generator, or given (`noise`).
A data-parallel rank's vec env (`rows`) holds its block of the global
batch: it draws every reset and the noise at the global batch and keeps
its rows, so R ranks' envs step what one process's do.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from onpolicy_torch.envs.mpe import scenarios as scenario_registry
from onpolicy_torch.envs.mpe.world import (WorldState, has_noise,
                                           physics_step, select)
from onpolicy_torch.utils import spaces as sp


class MPEEnv:
    """N env instances of one scenario as batched reset/step functions."""

    def __init__(self, scenario_name: str, num_agents: int,
                 num_landmarks: int, episode_length: int,
                 num_good_agents: int = 1, num_adversaries: int = 3):
        self.scenario = scenario_registry.load(scenario_name)
        args = SimpleNamespace(
            num_agents=num_agents, num_landmarks=num_landmarks,
            episode_length=episode_length, num_good_agents=num_good_agents,
            num_adversaries=num_adversaries)
        self.spec = spec = self.scenario.make_spec(args)
        self.scenario_name = scenario_name
        M = spec.n_agents

        # --- action spaces (discrete default) ---
        self.action_space = []
        self._move_col = np.full(M, -1)
        self._comm_col = np.full(M, -1)
        for i in range(M):
            heads = []
            if spec.agent_movable[i]:
                self._move_col[i] = len(heads)
                heads.append(5)
            if not spec.agent_silent[i] and spec.dim_c > 0:
                self._comm_col[i] = len(heads)
                heads.append(spec.dim_c)
            if len(heads) == 1:
                self.action_space.append(sp.Discrete(heads[0]))
            else:
                self.action_space.append(sp.MultiDiscrete(tuple(heads)))

        # --- observation spaces from a dummy reset ---
        st = self.scenario.reset(spec, 1, torch.Generator().manual_seed(0),
                                 "cpu", torch.float32)
        obs = self.scenario.observation(spec, st)
        self.observation_space = [sp.Box((int(o.shape[-1]),)) for o in obs]
        share_dim = sum(o.shape[-1] for o in obs)
        self.share_observation_space = [sp.Box((share_dim,))] * M

        self.num_agents = M
        self._sensitivity = np.array(
            [a if a is not None else 5.0 for a in spec.agent_accel],
            np.float64)

    def reset(self, n_envs: int, generator, device, dtype=torch.float32):
        state = self.scenario.reset(self.spec, n_envs, generator, device, dtype)
        return state, self.scenario.observation(self.spec, state)

    def observation(self, state: WorldState):
        return self.scenario.observation(self.spec, state)

    def _decode_actions(self, actions: torch.Tensor, like: torch.Tensor):
        """actions [N, M, n_heads] indices → (u [N, M, 2], c [N, M, dim_c])."""
        spec = self.spec
        M = spec.n_agents
        a = actions.to(torch.int64)
        mcol = torch.as_tensor(np.maximum(self._move_col, 0), device=a.device)
        mi = a.gather(2, mcol.expand(a.shape[0], M)[..., None])[..., 0]
        f = lambda b: b.to(like.dtype)
        ux = f(mi == 1) - f(mi == 2)
        uy = f(mi == 3) - f(mi == 4)
        sens = torch.as_tensor(self._sensitivity, dtype=like.dtype,
                               device=like.device)
        u = torch.stack([ux, uy], -1) * sens[:, None]
        movable = torch.as_tensor(np.array(spec.agent_movable), device=a.device)
        u = torch.where(movable[:, None], u, 0.0)

        if spec.dim_c > 0:
            has_comm = torch.as_tensor(self._comm_col >= 0, device=a.device)
            ccol = torch.as_tensor(np.maximum(self._comm_col, 0), device=a.device)
            ci = a.gather(2, ccol.expand(a.shape[0], M)[..., None])[..., 0]
            # a comparison, as jax.nn.one_hot: an index out of range gives
            # a zero row (F.one_hot raises, and syncs the card to check)
            c = f(ci[..., None] == torch.arange(spec.dim_c, device=a.device))
            c = torch.where(has_comm[:, None], c, 0.0)
        else:
            c = torch.zeros(a.shape[0], M, 1, dtype=like.dtype, device=like.device)
        return u, c

    def draw_noise(self, n_envs: int, generator, like: torch.Tensor):
        """The standard normal draws one step of this world's noise takes
        (`physics_step`'s `noise`), None if it has none."""
        need_u, need_c = has_noise(self.spec)
        if not (need_u or need_c):
            return None
        M = self.spec.n_agents
        randn = lambda *shape: torch.randn(*shape, generator=generator,
                                           dtype=like.dtype,
                                           device=like.device)
        noise = {}
        if need_u:
            noise["u"] = randn(n_envs, M, 2)
        if need_c:
            noise["c"] = randn(n_envs, M, self.spec.dim_c)
        return noise

    def step(self, state: WorldState, actions: torch.Tensor, noise=None):
        """→ (state', obs tuple, rewards [N, M, 1], done [N] bool).
        `noise`: the world's noise draws (`draw_noise`), where it has
        noise."""
        u, c = self._decode_actions(actions, state.agent_pos)
        state = physics_step(self.spec, state, u, c, noise)
        obs = self.scenario.observation(self.spec, state)
        rew = self.scenario.reward(self.spec, state)                # [N, M]
        if getattr(self.scenario, "shared_reward", False):
            rew = rew.sum(-1, keepdim=True).expand_as(rew)
        done = state.t >= self.spec.world_length
        return state, obs, rew[..., None], done


class MPEVecEnv:
    """N lockstep instances with auto-reset (the reference's ShareVecEnv),
    on one device, drawing resets from its own generator."""

    def __init__(self, env: MPEEnv, n_envs: int, device,
                 generator: torch.Generator, dtype=torch.float32,
                 rows: Optional[slice] = None, n_global: Optional[int] = None):
        """`rows` of `n_global` worlds: this rank's block of the global
        batch (then n_envs is the block's size)."""
        self.env = env
        self.n_envs = n_envs
        self.rows = rows
        self.n_draw = n_envs if rows is None else n_global
        self.num_agents = env.num_agents
        self.observation_space = env.observation_space
        self.share_observation_space = env.share_observation_space
        self.action_space = env.action_space
        self.device = torch.device(device)
        self.generator = generator
        self.dtype = dtype

    def _mine(self, x):
        return x if self.rows is None else x[self.rows]

    def reset(self):
        state = self.env.scenario.reset(self.env.spec, self.n_draw,
                                        self.generator, self.device,
                                        self.dtype)
        if self.rows is not None:
            state = WorldState.from_tensors(
                {k: self._mine(v) for k, v in state.tensors().items()})
        return state, self.env.observation(state)

    def step(self, states: WorldState, actions: torch.Tensor,
             reset_states: Optional[WorldState] = None, noise=None):
        """actions [N, M, heads] → (states', obs, rewards [N, M, 1],
        dones [N, M]). Finished envs restart from `reset_states` when
        given (pre-drawn, e.g. by a test), else from a fresh draw of the
        env's generator; they return the fresh obs with the terminal
        rewards/dones. A world with noise takes `noise` when given, else
        draws it from the env's generator."""
        if noise is None:
            noise = self.env.draw_noise(self.n_draw, self.generator,
                                        states.agent_pos)
            if noise is not None:
                noise = {k: self._mine(v) for k, v in noise.items()}
        states2, obs, rew, done = self.env.step(states, actions, noise)
        if reset_states is None:
            reset_states, reset_obs = self.reset()
        else:
            reset_obs = self.env.observation(reset_states)
        states3 = select(done, reset_states, states2)
        obs3 = tuple(torch.where(done[:, None], r, o)
                     for r, o in zip(reset_obs, obs))
        dones = done[:, None].expand(self.n_envs, self.num_agents)
        return states3, obs3, rew, dones


def make_vec_env(cfg, device, generator, n_envs: int = None,
                 dtype=torch.float32, mesh=None) -> MPEVecEnv:
    """`n_envs` (default cfg.n_rollout_threads) worlds; over a data `mesh`
    this rank's block of them."""
    env = MPEEnv(cfg.scenario_name, cfg.num_agents, cfg.num_landmarks,
                 cfg.episode_length, getattr(cfg, "num_good_agents", 1),
                 getattr(cfg, "num_adversaries", 3))
    n = n_envs or cfg.n_rollout_threads
    if mesh is None:
        return MPEVecEnv(env, n, device, generator, dtype)
    rows = mesh.rows(n)
    return MPEVecEnv(env, rows.stop - rows.start, device, generator, dtype,
                     rows=rows, n_global=n)
