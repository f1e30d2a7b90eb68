"""Shared-policy runner for the batched MPE envs.

Port of `onpolicy_tpu/runner/shared_runner.py` (the reference's
`runner/shared/mpe_runner.py`). One `episode()` is:

    rollout = T × (policy act → env step → stage)    (plain torch)
    buffer  = [T+1] slots from the staged steps
    returns = bootstrap value + reverse GAE
    update  = ppo_epoch × num_mini_batch PPO steps    (GRU kernels on the card)

The carry (env states, obs, rnn states, masks) flows straight into the
next episode. All randomness on the path (action draws, env resets,
minibatch permutations) comes from one `torch.Generator` on the run's
device, seeded with cfg.seed; parameters are drawn from a CPU generator
with the same seed. `rollout` takes optional per-step injections (the
actions and the reset states), so a test can hold it in lockstep with
another implementation.

It trains the shared-policy algorithms rmappo, mappo and ippo. With
`use_critic_dedup` (feed-forward mappo, centralized V) the critic runs on
one row per env in the rollout step and in the bootstrap, since
share_obs is the same for every agent of an env, and the value is
broadcast to the agents.

Not ported yet, and refused here with their ROADMAP.md items: eval
(`use_eval`), `episodes_per_call > 1`, the profiler trace
(`profile_dir`), multi-device meshes, and the separated-policy and
transformer algorithms.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.algorithms.mappo import MAPPO
from onpolicy_torch.envs.mpe import make_vec_env
from onpolicy_torch.envs.mpe.world import WorldState
from onpolicy_torch.utils import checkpoint as ckpt_lib
from onpolicy_torch.utils import spaces as sp


def refuse_unported(cfg):
    """Raise NotImplementedError for options whose port is still to come."""
    todo = []
    if cfg.algorithm_name not in ("rmappo", "mappo", "ippo"):
        todo.append(f"algorithm {cfg.algorithm_name!r} (ROADMAP.md Queue 1 "
                    "items 11-14; the port trains rmappo, mappo and ippo)")
    if cfg.use_eval:
        todo.append("use_eval (ROADMAP.md Queue 1 item A2)")
    if cfg.episodes_per_call > 1:
        todo.append("episodes_per_call > 1 (ROADMAP.md Queue 1 item A6)")
    if cfg.profile_dir is not None:
        todo.append("profile_dir (ROADMAP.md Queue 1 item A3)")
    if int(np.prod(cfg.mesh_shape)) > 1:
        todo.append("multi-device mesh_shape (ROADMAP.md Queue 1 item 18)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


class SharedRunner:
    def __init__(self, cfg, vec_env=None):
        cfg = cfg.validate()
        refuse_unported(cfg)
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.init_generator = torch.Generator().manual_seed(cfg.seed)
        self.envs = vec_env if vec_env is not None else make_vec_env(
            cfg, self.device, self.generator)
        self.num_agents = self.envs.num_agents
        self.N = self.envs.n_envs

        if len({sp.obs_shape(s) for s in self.envs.observation_space}) != 1 \
                or len(set(self.envs.action_space)) != 1:
            raise ValueError("shared policy requires homogeneous obs and "
                             "action spaces")
        obs_space = self.envs.observation_space[0]
        share_obs_space = (self.envs.share_observation_space[0]
                           if cfg.use_centralized_V else obs_space)
        self.act_space = self.envs.action_space[0]
        self.episodes = int(cfg.num_env_steps) // cfg.episode_length // self.N
        self.algo = MAPPO(cfg, obs_space, share_obs_space, self.act_space,
                          total_updates=self.episodes)
        self.start_episode = 0

    # ------------------------------------------------------------------
    def _generators(self) -> dict:
        return {"device": self.generator, "init": self.init_generator}

    def init(self):
        """→ (train_state, carry). With cfg.model_dir, the train state,
        carry, generators and episode counter come from its checkpoint."""
        train_state = self.algo.init_state(self.init_generator, self.device)
        env_states, obs = self.envs.reset()
        carry = self._fresh_carry(env_states, obs)
        self.start_episode = 0
        if self.cfg.model_dir:
            train_state, step, saved = ckpt_lib.restore(
                self.cfg.model_dir, train_state, self.device,
                self._generators())
            self.start_episode = step
            if saved is not None:
                carry = {**saved,
                         "env_states": WorldState.from_tensors(saved["env_states"])}
        return train_state, carry

    def _fresh_carry(self, env_states, obs):
        N, M, cfg = self.N, self.num_agents, self.cfg
        zeros = lambda: torch.zeros(N, M, cfg.recurrent_N, cfg.hidden_size,
                                    device=self.device)
        return {"env_states": env_states, "obs": torch.stack(obs, 1),
                "rnn_actor": zeros(), "rnn_critic": zeros(),
                "masks": torch.ones(N, M, 1, device=self.device)}

    def _share_obs(self, obs):
        """[N, M, D] → centralized critic input [N, M, M·D] (all agents'
        obs, the same row for every agent), or obs itself (IPPO)."""
        if not self.cfg.use_centralized_V:
            return obs
        N, M, D = obs.shape
        return obs.reshape(N, 1, M * D).expand(N, M, M * D)

    def _values(self, train_state, share_obs, rnn_critic, masks):
        """Critic values [N, M, 1] and its next rnn states [N, M, L, H].
        With `use_critic_dedup` they come from `Critic.forward_dedup` (one
        critic row per env) and the rnn states pass through."""
        N, M = self.N, self.num_agents
        critic, params = self.algo.critic, train_state.critic_params
        if self.cfg.use_critic_dedup:
            return critic.forward_dedup(params, share_obs, rnn_critic,
                                        masks), rnn_critic
        flat = lambda x: x.reshape(N * M, *x.shape[2:])
        v, rnn = critic.forward(params, flat(share_obs), flat(rnn_critic),
                                flat(masks))
        return v.reshape(N, M, 1), rnn.reshape(rnn_critic.shape)

    # ---- one training episode ----------------------------------------
    @torch.no_grad()
    def rollout(self, train_state, carry, inject: Optional[Sequence[dict]] = None):
        """Collect T steps and compute returns. `inject[t]` may hold
        "actions" [N, M, 1] to take instead of a draw and "reset_states"
        (a `WorldState` of N worlds) for the envs that finish at step t.
        → (carry after the last step, buffer with returns/advantages)."""
        cfg = self.cfg
        N, M = self.N, self.num_agents
        flat = lambda x: x.reshape(N * M, *x.shape[2:])
        unflat = lambda x: x.reshape(N, M, *x.shape[1:])
        staged = []
        c = carry
        for t in range(cfg.episode_length):
            inj = inject[t] if inject is not None else {}
            given = inj.get("actions")
            obs = c["obs"]
            share_obs = self._share_obs(obs)
            actions, logp, rnn_a = self.algo.actor.forward(
                train_state.actor_params, flat(obs), flat(c["rnn_actor"]),
                flat(c["masks"]), self.generator,
                actions=None if given is None else flat(given))
            values, rnn_c = self._values(train_state, share_obs,
                                         c["rnn_critic"], c["masks"])
            actions_env = unflat(actions)
            env_states, obs2, rewards, dones = self.envs.step(
                c["env_states"], actions_env, inj.get("reset_states"))
            staged.append({
                "share_obs": share_obs, "obs": obs,
                "rnn_states": c["rnn_actor"],
                "rnn_states_critic": c["rnn_critic"],
                "actions": actions_env, "action_log_probs": unflat(logp),
                "value_preds": values, "rewards": rewards,
                "masks": c["masks"], "active_masks": torch.ones_like(c["masks"]),
            })
            c = {"env_states": env_states, "obs": torch.stack(obs2, 1),
                 "rnn_actor": unflat(rnn_a), "rnn_critic": rnn_c,
                 "masks": 1.0 - dones[..., None].float()}

        traj = {k: torch.stack([s[k] for s in staged]) for k in staged[0]}
        last = {"share_obs": self._share_obs(c["obs"]), "obs": c["obs"],
                "rnn_states": c["rnn_actor"], "rnn_states_critic": c["rnn_critic"],
                "masks": c["masks"], "active_masks": torch.ones_like(c["masks"])}
        buf = buf_lib.from_rollout(traj, last)
        next_values, _ = self._values(train_state, last["share_obs"],
                                      c["rnn_critic"], c["masks"])
        buf = buf.compute_returns(
            next_values, train_state.vnorm, gamma=cfg.gamma,
            gae_lambda=cfg.gae_lambda, use_gae=cfg.use_gae,
            use_proper_time_limits=cfg.use_proper_time_limits)
        return c, buf

    def episode(self, train_state, carry):
        """→ (train_state, carry, metrics as 0-dim tensors)."""
        carry2, buf = self.rollout(train_state, carry)
        train_state, metrics = self.algo.train(train_state, buf, self.generator)
        metrics["average_episode_rewards"] = (
            buf.rewards.mean() * self.cfg.episode_length)
        per_agent = buf.rewards.mean((0, 1, 3))
        for i in range(self.num_agents):
            metrics[f"agent{i}/individual_rewards"] = per_agent[i]
        return train_state, carry2, metrics

    # ---- host training loop ------------------------------------------
    def _save(self, save_dir, train_state, carry, step):
        flat_carry = {**carry, "env_states": carry["env_states"].tensors()}
        ckpt_lib.save(save_dir, train_state, step, self._generators(),
                      flat_carry)

    def run(self, log_fn=print, save_dir=None):
        cfg = self.cfg
        train_state, carry = self.init()
        start_episode = self.start_episode
        start = time.perf_counter()
        history = []
        for episode in range(start_episode, self.episodes):
            train_state, carry, metrics = self.episode(train_state, carry)
            last = episode + 1 >= self.episodes
            if episode % cfg.log_interval == 0 or last:
                metrics = {k: float(v) for k, v in metrics.items()}
                steps = cfg.episode_length * self.N
                fps = (episode + 1 - start_episode) * steps \
                    / (time.perf_counter() - start)
                row = {"episode": episode, "steps": (episode + 1) * steps,
                       "fps": fps, **metrics}
                history.append(row)
                if log_fn is print:
                    print(f"ep {episode} steps {row['steps']} fps {fps:,.0f} "
                          f"rew {row['average_episode_rewards']:.2f} "
                          f"vloss {row['value_loss']:.3f} "
                          f"ploss {row['policy_loss']:.3f}")
                elif log_fn is not None:
                    log_fn(row)
            if save_dir and (episode % max(cfg.save_interval, 1) == 0 or last):
                self._save(save_dir, train_state, carry, episode + 1)
        return train_state, history
