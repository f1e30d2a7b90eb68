"""Shared-policy runner for the batched MPE envs.

Port of `onpolicy_tpu/runner/shared_runner.py` (the reference's
`runner/shared/mpe_runner.py`). One `episode()` is:

    rollout = T × (policy act → env step → stage)    (plain torch)
    buffer  = [T+1] slots from the staged steps
    returns = bootstrap value + reverse GAE
    update  = ppo_epoch × num_mini_batch PPO steps    (GRU kernels on the card)

The carry (env states, obs, rnn states, masks) flows straight into the
next episode. `rollout` takes optional per-step injections (the actions
and the reset states), and `eval_episode` optional initial worlds, so a
test can hold them in lockstep with another implementation. The host
loop, checkpoints, eval schedule, `episodes_per_call` and the profiler
trace are `base_runner.BaseRunner`'s. The rollout's layers are marked
by `utils.profiling` spans: `rollout.act`, `rollout.env`,
`rollout.store` and `rollout.returns`.

It trains the shared-policy algorithms rmappo, mappo, ippo and MAT (mat,
mat_dec; `algorithms/mat.py`), and acts only through the trainer's
rollout-time interface (`algorithms/__init__.py`) on the [N, M, ...]
carry: `get_actions` a rollout step (an injected draw is each agent's
action), `get_values` the bootstrap value, and `act` the eval
(`eval_episode`: each head's mode for one episode of the eval env). What
the critic reads, and whether it runs once per env (`use_critic_dedup`),
is the trainer's business.

Over a data mesh each rank steps and acts for its block of the envs
(`base_runner`); the staged steps and the last slot are gathered into
the whole episode, whose bootstrap values, returns and update every rank
computes (the update on its share of each minibatch, `algorithms/mappo.py`).
On a `(data, model)` mesh `rollout` and `eval_episode` take the state
with the full parameters, gathered once before them
(`BaseRunner._state`), and the trainer gathers them for each
minibatch.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.algorithms import HAPPO, MAT, make_trainer, trainer_class
from onpolicy_torch.envs.mpe.world import WorldState
from onpolicy_torch.runner.base_runner import BaseRunner
from onpolicy_torch.utils import profiling
from onpolicy_torch.utils import spaces as sp


class SharedRunner(BaseRunner):
    def __init__(self, cfg, vec_env=None, eval_env=None):
        super().__init__(cfg, vec_env, eval_env)
        cfg = self.cfg
        Algo = trainer_class(cfg)
        if issubclass(Algo, HAPPO):
            raise ValueError(f"{Algo.__name__} updates one agent at a time: "
                             "it trains through the separated runner "
                             "(runner/separated_runner.py)")
        if len({sp.obs_shape(s) for s in self.envs.observation_space}) != 1 \
                or len(set(self.envs.action_space)) != 1:
            raise ValueError("shared policy requires homogeneous obs and "
                             "action spaces; use the separated runner "
                             "(share_policy false)")
        obs_space = self.envs.observation_space[0]
        share_obs_space = (self.envs.share_observation_space[0]
                           if cfg.use_centralized_V else obs_space)
        self.act_space = self.envs.action_space[0]
        self.algo = make_trainer(cfg, obs_space, share_obs_space,
                                 self.act_space, total_updates=self.episodes,
                                 num_agents=self.num_agents, mesh=self.mesh)
        self.is_mat = isinstance(self.algo, MAT)

    # ------------------------------------------------------------------
    def init(self):
        """→ (train_state, carry). With cfg.model_dir, the train state,
        carry, generators and episode counter come from its checkpoint."""
        train_state = self.algo.init_state(self.init_generator, self.device)
        env_states, obs = self.envs.reset()
        return self._restore(train_state, self._fresh_carry(env_states, obs))

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

    # ---- one training episode ----------------------------------------
    @torch.no_grad()
    def rollout(self, train_state, carry, inject: Optional[Sequence[dict]] = None):
        """Collect T steps and compute returns. `inject[t]` may hold
        "actions" [N, M, heads] to take instead of a draw and "reset_states"
        (a `WorldState` of N worlds) for the envs that finish at step t.
        → (carry after the last step, buffer with returns/advantages)."""
        cfg = self.cfg
        staged = []
        c = carry
        for t in range(cfg.episode_length):
            inj = inject[t] if inject is not None else {}
            obs = c["obs"]
            share_obs = self._share_obs(obs)
            with profiling.span("rollout.act"):
                values, actions, logp, rnn_a, rnn_c = self.algo.get_actions(
                    train_state, share_obs, obs, c["rnn_actor"],
                    c["rnn_critic"], c["masks"], self.draws,
                    actions=inj.get("actions"))
            with profiling.span("rollout.env"):
                env_states, obs2, rewards, dones = self.envs.step(
                    c["env_states"], actions, inj.get("reset_states"))
            with profiling.span("rollout.store"):
                staged.append({
                    "share_obs": share_obs, "obs": obs,
                    "rnn_states": c["rnn_actor"],
                    "rnn_states_critic": c["rnn_critic"],
                    "actions": actions, "action_log_probs": logp,
                    "value_preds": values, "rewards": rewards,
                    "masks": c["masks"],
                    "active_masks": torch.ones_like(c["masks"]),
                })
                c = {"env_states": env_states, "obs": torch.stack(obs2, 1),
                     "rnn_actor": rnn_a, "rnn_critic": rnn_c,
                     "masks": 1.0 - dones[..., None].float()}

        with profiling.span("rollout.store"):
            traj = {k: torch.stack([s[k] for s in staged]) for k in staged[0]}
            last = {"share_obs": self._share_obs(c["obs"]), "obs": c["obs"],
                    "rnn_states": c["rnn_actor"],
                    "rnn_states_critic": c["rnn_critic"], "masks": c["masks"],
                    "active_masks": torch.ones_like(c["masks"])}
            traj, last = self._gather_episode(traj, last)
            buf = buf_lib.from_rollout(traj, last)
        with profiling.span("rollout.returns"):
            next_values, _ = self.algo.get_values(
                train_state, last["share_obs"], last["rnn_states_critic"],
                last["masks"], last["obs"])
            buf = buf.compute_returns(
                next_values, train_state.vnorm, gamma=cfg.gamma,
                gae_lambda=cfg.gae_lambda, use_gae=cfg.use_gae,
                use_proper_time_limits=cfg.use_proper_time_limits)
        return c, buf

    def episode(self, train_state, carry):
        """→ (train_state, carry, metrics as 0-dim tensors)."""
        carry2, buf = self.rollout(self._state(train_state, "gathered"),
                                   carry)
        train_state, metrics = self.algo.train(train_state, buf, self.generator)
        metrics["average_episode_rewards"] = (
            buf.rewards.mean() * self.cfg.episode_length)
        per_agent = buf.rewards.mean((0, 1, 3))
        for i in range(self.num_agents):
            metrics[f"agent{i}/individual_rewards"] = per_agent[i]
        return train_state, carry2, metrics

    # ---- evaluation --------------------------------------------------
    @torch.no_grad()
    def eval_episode(self, train_state,
                     init_states: Optional[WorldState] = None) -> torch.Tensor:
        """One episode of the eval env from fresh worlds (its own draw, or
        `init_states`), each head's mode taken; → the mean over envs and
        agents of the episode's return (JAX `_eval_episode`)."""
        cfg, env = self.cfg, self.eval_envs
        N, M = env.n_envs, self.num_agents
        if init_states is None:
            env_states, obs = env.reset()
        else:
            env_states, obs = init_states, env.env.observation(init_states)
        obs = torch.stack(obs, 1)
        rnn = torch.zeros(N, M, cfg.recurrent_N, cfg.hidden_size,
                          device=self.device)
        masks = torch.ones(N, M, 1, device=self.device)
        total = torch.zeros(N, M, 1, device=self.device)
        for _ in range(cfg.episode_length):
            actions, _, rnn = self.algo.act(
                train_state, obs, rnn, masks, deterministic=True,
                share_obs=self._share_obs(obs))
            env_states, obs, rewards, dones = env.step(env_states, actions)
            obs = torch.stack(obs, 1)
            masks = 1.0 - dones[..., None].float()
            total = total + rewards
        return total.mean()
