"""Per-agent policies over host envs (HAPPO / HATRPO / separated MAPPO on
SMAC and the like).

Port of `onpolicy_tpu/runner/host_separated_runner.py` (the reference's
`runner/separated/smac_runner.py` with `separated/base_runner.py:
135-183`): the host loop of `runner/host_runner.HostRunner` (staged
rollout, masks, evaluation, checkpoints, `run`) with one trainer an
agent. The agents share obs and action spaces (the SMAC case); each has
its own parameters, optimizers and normalizer. A rollout step is each
agent's `get_actions` on its column of the fleet.

The update (JAX's `_train`, `:83-110` there) trains each agent on its
slice [T, N, 1, ...] of the whole [T, N, M] buffer. HAPPO and HATRPO go
one agent at a time in an order drawn each episode from
`np.random.default_rng(cfg.seed)` (replayed on resume), the running
factor [T, N, 1, 1] starting at ones and multiplied after each agent's
update by exp(Σ_heads (new − old log-probs)) of that agent's whole
episode (`evaluate_full_logp`: on the card the forward kernel at T =
episode length, B = N). As JAX's, GAE over the whole buffer denormalizes
every agent's values with agent 0's normalizer, and bad_masks come from
each env's first info. HATRPO's GRU is the plain scan (its double
backward, `models/gru.py`), as in `runner/separated_runner.py`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from onpolicy_torch.algorithms import HAPPO, MAPPO, trainer_class
from onpolicy_torch.runner.host_runner import HostRunner


class HostSeparatedRunner(HostRunner):
    def _make_algos(self, obs_space, share_space):
        cfg = self.cfg
        Algo = trainer_class(cfg)
        if not issubclass(Algo, MAPPO):
            raise ValueError(f"{Algo.__name__} trains through "
                             "runner/host_runner.HostSharedRunner")
        self.algos: List[MAPPO] = [
            Algo(cfg, obs_space, share_space, self.act_space,
                 total_updates=self.episodes, num_agents=1, mesh=self.mesh)
            for _ in range(self.num_agents)]
        self.is_happo = issubclass(Algo, HAPPO)
        self.order_rng = np.random.default_rng(cfg.seed)

    def _init_state(self):
        return tuple(a.init_state(self.init_generator, self.device)
                     for a in self.algos)

    def init(self):
        """`HostRunner.init`, and the agent orders of the episodes already
        run drawn again, so that a resumed run draws the same orders."""
        states, start = super().init()
        self.order_rng = np.random.default_rng(self.cfg.seed)
        if self.is_happo:
            for _ in range(self.start_episode):
                self.order_rng.permutation(self.num_agents)
        return states, start

    def _bad_masks(self, infos) -> np.ndarray:
        bad = np.ones((self.N, self.num_agents, 1), np.float32)
        for n, info in enumerate(infos):
            im = info[0] if isinstance(info, (list, tuple)) else info
            if isinstance(im, dict) and im.get("bad_transition"):
                bad[n] = 0.0
        return bad

    def _act(self, states, x, rnn_a, rnn_c, given):
        agent = lambda y, i: None if y is None else y[:, i]
        outs = [algo.get_actions(
            states[i], x["share_obs"][:, i], x["obs"][:, i], rnn_a[:, i],
            rnn_c[:, i], x["masks"][:, i], self.draws,
            agent(x.get("available_actions"), i), actions=agent(given, i))
            for i, algo in enumerate(self.algos)]
        return tuple(torch.stack(col, 1) for col in zip(*outs))

    def _bootstrap(self, states, buf):
        next_values = torch.stack([
            algo.get_values(states[i], buf.share_obs[-1][:, i],
                            buf.rnn_states_critic[-1][:, i],
                            buf.masks[-1][:, i])[0]
            for i, algo in enumerate(self.algos)], 1)
        return next_values, states[0].vnorm

    def update(self, states, buf, order: Optional[Sequence[int]] = None):
        """Train each agent on its slice of `buf`; HAPPO and HATRPO in
        `order` (drawn from the runner's numpy generator when None) with
        the factor, the others in turn. → (states, metrics
        "agent<i>/<name>")."""
        states = list(states)
        metrics = {}
        factor = None
        if self.is_happo:
            if order is None:
                order = self.order_rng.permutation(self.num_agents)
            factor = torch.ones(buf.T, buf.n_rollout_threads, 1, 1,
                                device=self.device)
        else:
            order = range(self.num_agents)
        for i in order:
            i = int(i)
            algo = self.algos[i]
            buf_i = buf.replace(**{
                f: getattr(buf, f)[:, :, i:i + 1]
                for f in buf.__dataclass_fields__
                if getattr(buf, f) is not None})
            old = algo.evaluate_full_logp(states[i], buf_i) \
                if self.is_happo else None
            states[i], m = algo.train(states[i], buf_i, self.generator,
                                      factor=factor)
            if self.is_happo:
                new = algo.evaluate_full_logp(states[i], buf_i)
                factor = factor * torch.exp((new - old).sum(-1, keepdim=True))
            metrics.update({f"agent{i}/{k}": v for k, v in m.items()})
        return tuple(states), metrics

    def _eval_act(self, states, obs, rnn, masks, avail):
        outs = [algo.act(states[i], obs[:, i], rnn[:, i], masks[:, i],
                         available_actions=None if avail is None
                         else avail[:, i], deterministic=True)
                for i, algo in enumerate(self.algos)]
        return (torch.stack([a for a, _, _ in outs], 1),
                torch.stack([r for _, _, r in outs], 1))
