"""Separated-policy runner: per-agent networks (heterogeneous spaces),
with HAPPO's sequential update.

Port of `onpolicy_tpu/runner/separated_runner.py` (the reference's
`runner/separated/{base_runner,mpe_runner}.py`). Each agent has its own
trainer (`MAPPO`, or `HAPPO` / `HATRPO` for happo / hatrpo) over its own
obs and action spaces; its centralized critic reads the concatenation of
every agent's obs. Each agent has its own `RolloutBuffer` with a singleton agent axis,
and the envs' masks are one column [N, 1] shared by the agents. Actions
are padded to the widest action head before the env step.

HAPPO and HATRPO (base_runner.py:135-183 of the reference): the agents
update one at a time in an order drawn on the host each episode with
`np.random.default_rng(cfg.seed).permutation`, as the JAX package draws
it. The running `factor` [T, N, 1, 1] starts at ones; after each agent's
update it is multiplied by exp(Σ_heads (new − old log-probs)) of that
agent's whole episode (`MAPPO.evaluate_full_logp`), and the next agent's
surrogate is weighted by it.

`rollout` takes per-step injected actions and reset states, `update` and
`episode` an explicit order, and `eval_episode` initial worlds, so a test
can hold them to the JAX package. The host loop and checkpoints (the
tuple of per-agent states) are `base_runner.BaseRunner`'s. Over a data
mesh each rank steps its block of the envs and every agent's episode is
gathered into its whole buffer before the returns and the update, as in
`runner/shared_runner.py`; on a `(data, model)` mesh `rollout` and
`eval_episode` take the states with each agent's full parameters
(`BaseRunner._state`), and each trainer gathers them for each
minibatch and each whole-episode log-prob.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.algorithms import HAPPO, MAPPO, trainer_class
from onpolicy_torch.envs.mpe.world import WorldState
from onpolicy_torch.runner.base_runner import BaseRunner
from onpolicy_torch.utils import spaces as sp


class SeparatedRunner(BaseRunner):
    def __init__(self, cfg, vec_env=None, eval_env=None):
        super().__init__(cfg, vec_env, eval_env)
        cfg = self.cfg
        Algo = trainer_class(cfg)
        if not issubclass(Algo, MAPPO):
            raise ValueError(f"{Algo.__name__} trains through the shared "
                             "runner (runner/shared_runner.py)")
        self.is_happo = issubclass(Algo, HAPPO)
        obs_spaces = self.envs.observation_space
        share_space = sp.Box((sum(sp.obs_shape(s)[0] for s in obs_spaces),))
        self.algos: List[MAPPO] = [
            Algo(cfg, obs_spaces[i],
                 share_space if cfg.use_centralized_V else obs_spaces[i],
                 self.envs.action_space[i], total_updates=self.episodes,
                 num_agents=1, mesh=self.mesh)
            for i in range(self.num_agents)]
        self.max_heads = max(sp.action_storage_dim(s)
                             for s in self.envs.action_space)
        self.order_rng = np.random.default_rng(cfg.seed)

    # ------------------------------------------------------------------
    def init(self):
        """→ (tuple of per-agent train states, carry). With cfg.model_dir
        they come from its checkpoint, with the generators and the
        episode counter; the agent orders of the episodes already run
        are drawn again, so a resumed run draws the same orders."""
        states = tuple(a.init_state(self.init_generator, self.device)
                       for a in self.algos)
        env_states, obs = self.envs.reset()
        N, M, cfg = self.N, self.num_agents, self.cfg
        zeros = lambda: tuple(
            torch.zeros(N, cfg.recurrent_N, cfg.hidden_size,
                        device=self.device) for _ in range(M))
        carry = {"env_states": env_states, "obs": tuple(obs),
                 "rnn_actor": zeros(), "rnn_critic": zeros(),
                 "masks": torch.ones(N, 1, device=self.device)}
        states, carry = self._restore(states, carry)
        self.order_rng = np.random.default_rng(cfg.seed)
        if self.is_happo:
            for _ in range(self.start_episode):
                self.order_rng.permutation(M)
        return states, carry

    def _share_obs(self, obs, i):
        """Agent i's critic input: every agent's obs concatenated
        [N, ΣD], or its own obs (decentralized V)."""
        return torch.cat(obs, -1) if self.cfg.use_centralized_V else obs[i]

    def _pad(self, actions):
        return torch.nn.functional.pad(
            actions, (0, self.max_heads - actions.shape[-1]))

    # ---- one training episode ----------------------------------------
    @torch.no_grad()
    def rollout(self, states, carry, inject: Optional[Sequence[dict]] = None):
        """Collect T steps and compute each agent's returns. `inject[t]`
        may hold "actions", a sequence of per-agent [N, heads_i] actions
        to take instead of draws, and "reset_states" (a `WorldState` of N
        worlds) for the envs that finish at step t.
        → (carry after the last step, list of per-agent buffers)."""
        cfg, M = self.cfg, self.num_agents
        staged = [[] for _ in range(M)]
        c = carry
        for t in range(cfg.episode_length):
            inj = inject[t] if inject is not None else {}
            given = inj.get("actions")
            env_actions, rnn_a, rnn_c = [], [], []
            for i, algo in enumerate(self.algos):
                so = self._share_obs(c["obs"], i)
                values, actions, logp, ra, rc = algo.get_actions(
                    states[i], so, c["obs"][i], c["rnn_actor"][i],
                    c["rnn_critic"][i], c["masks"], self.draws,
                    actions=None if given is None else given[i])
                env_actions.append(self._pad(actions))
                rnn_a.append(ra)
                rnn_c.append(rc)
                staged[i].append({
                    "share_obs": so, "obs": c["obs"][i],
                    "rnn_states": c["rnn_actor"][i],
                    "rnn_states_critic": c["rnn_critic"][i],
                    "actions": actions, "action_log_probs": logp,
                    "value_preds": values, "masks": c["masks"],
                    "active_masks": torch.ones_like(c["masks"])})
            env_states, obs2, rewards, dones = self.envs.step(
                c["env_states"], torch.stack(env_actions, 1),
                inj.get("reset_states"))
            for i in range(M):
                staged[i][-1]["rewards"] = rewards[:, i]
            c = {"env_states": env_states, "obs": tuple(obs2),
                 "rnn_actor": tuple(rnn_a), "rnn_critic": tuple(rnn_c),
                 "masks": 1.0 - dones[:, :1].float()}

        # every agent's steps [T, N, 1, ...] and last slot [N, 1, ...], the
        # agents' in one gather over a mesh
        traj, last = {}, {}
        for i in range(M):
            last.update({(i, k): v.unsqueeze(1) for k, v in {
                "share_obs": self._share_obs(c["obs"], i),
                "obs": c["obs"][i], "rnn_states": c["rnn_actor"][i],
                "rnn_states_critic": c["rnn_critic"][i],
                "masks": c["masks"],
                "active_masks": torch.ones_like(c["masks"])}.items()})
            traj.update({(i, k): torch.stack([s[k] for s in staged[i]])
                         .unsqueeze(2) for k in staged[i][0]})
        traj, last = self._gather_episode(traj, last)
        bufs = []
        for i, algo in enumerate(self.algos):
            mine = lambda d: {k: v for (j, k), v in d.items() if j == i}
            buf = buf_lib.from_rollout(mine(traj), mine(last))
            last_i = {k: v[:, 0] for k, v in mine(last).items()}
            next_value, _ = algo.get_values(states[i], last_i["share_obs"],
                                            last_i["rnn_states_critic"],
                                            last_i["masks"])
            bufs.append(buf.compute_returns(
                next_value[:, None], states[i].vnorm, gamma=cfg.gamma,
                gae_lambda=cfg.gae_lambda, use_gae=cfg.use_gae,
                use_proper_time_limits=cfg.use_proper_time_limits))
        return c, bufs

    def update(self, states, bufs, order: Optional[Sequence[int]] = None):
        """Train every agent on its buffer. HAPPO and HATRPO go one agent
        at a time in `order` (drawn from the runner's numpy generator when
        None), weighting each by the factor of the agents before it; the
        others train each agent in turn. → (states, metrics "agent<i>/<name>")."""
        states = list(states)
        metrics = {}
        if self.is_happo:
            if order is None:
                order = self.order_rng.permutation(self.num_agents)
            T, N = bufs[0].T, bufs[0].n_rollout_threads
            factor = torch.ones(T, N, 1, 1, device=self.device)
        else:
            order, factor = range(self.num_agents), None
        for i in order:
            i = int(i)
            algo = self.algos[i]
            old = algo.evaluate_full_logp(states[i], bufs[i]) \
                if self.is_happo else None
            states[i], m = algo.train(states[i], bufs[i], self.generator,
                                      factor=factor)
            if self.is_happo:
                new = algo.evaluate_full_logp(states[i], bufs[i])
                factor = factor * torch.exp((new - old).sum(-1, keepdim=True))
            metrics.update({f"agent{i}/{k}": v for k, v in m.items()})
        return tuple(states), metrics

    def episode(self, states, carry, order: Optional[Sequence[int]] = None):
        """→ (states, carry, metrics as 0-dim tensors)."""
        carry2, bufs = self.rollout(self._state(states, "gathered"), carry)
        states, metrics = self.update(states, bufs, order)
        rewards = torch.stack([b.rewards for b in bufs], 2)
        metrics["average_episode_rewards"] = (
            rewards.mean() * self.cfg.episode_length)
        return states, carry2, metrics

    # ---- evaluation --------------------------------------------------
    @torch.no_grad()
    def eval_episode(self, states,
                     init_states: Optional[WorldState] = None) -> torch.Tensor:
        """One episode of the eval env from fresh worlds (its own draw, or
        `init_states`), each head's mode taken; the rnn states are
        multiplied by the masks after each step, as the JAX package's
        separated eval does. → mean over envs and agents of the return."""
        cfg, env = self.cfg, self.eval_envs
        N = env.n_envs
        if init_states is None:
            env_states, obs = env.reset()
        else:
            env_states, obs = init_states, env.env.observation(init_states)
        rnn = [torch.zeros(N, cfg.recurrent_N, cfg.hidden_size,
                           device=self.device) for _ in self.algos]
        masks = torch.ones(N, 1, device=self.device)
        total = torch.zeros(N, self.num_agents, 1, device=self.device)
        for _ in range(cfg.episode_length):
            env_actions = []
            for i, algo in enumerate(self.algos):
                actions, _, rnn[i] = algo.act(states[i], obs[i], rnn[i],
                                              masks, deterministic=True)
                env_actions.append(self._pad(actions))
            env_states, obs, rewards, dones = env.step(
                env_states, torch.stack(env_actions, 1))
            masks = 1.0 - dones[:, :1].float()
            rnn = [r * masks[:, None] for r in rnn]
            total = total + rewards
        return total.mean()
