"""MAPPO / IPPO / rMAPPO: shared-policy trainer.

Port of `onpolicy_tpu/algorithms/mappo.py` (the reference's
`rMAPPOPolicy.py` + `r_mappo.py`). All state threads through
`TrainState`: parameter trees (JAX layout), the two optimizer states
(actor and critic have separate Adams, lr / critic_lr) and the
ValueNorm statistics. `train()` normalizes the advantages with the active
masks, then runs ppo_epoch × num_mini_batch `_update` steps. In
`_update` the normalizer is updated on the raw returns BEFORE the
gradient step (the reference's order), and the grad norms logged are
taken before the clip. IPPO is this trainer with a decentralized critic
input (`use_centralized_V=False`, set by the config's canonicalization).

Three samplers (`_sample_minibatches`): chunked BPTT (rMAPPO), whole
episodes (`use_naive_recurrent_policy`) and flat rows (feed-forward).
`utils.profiling` spans mark the update's layers: `update.minibatch`,
then per minibatch `update.forward`, `update.backward`,
`update.allreduce` and `update.optimizer` (the three device spans timed
on the card by CUDA events).
The recurrent policies' update runs `evaluate_seq` / `forward_seq`
through the sequence GRU, which on the card is the CUDA kernels; the
feed-forward update evaluates flat rows, with `use_critic_dedup` running
the critic once per env. HAPPO (`algorithms/happo.py`) is this trainer
with the joint ratio over action heads; its sequential-update `factor`
goes through `train` to the sampler and the loss, and
`evaluate_full_logp` gives the whole-episode log-probs it is built from.

`use_popart` (JAX `mappo.py:83, 136-146`): the statistics live in the
state's `vnorm`, which exists under `use_popart` or `use_valuenorm`.
Before each loss `popart.update` folds the returns into them and rescales
the critic's `v_out` so that its denormalized outputs stay put
(`popart_rescales_head`); Adam's moments of `v_out` are not rescaled, in
either package. HAPPO and HATRPO keep the stats-only normalizer under
`use_popart` (the reference's popart_hatrpo.py is a ValueNorm clone).

Data parallelism (`mesh`, a `parallel.mesh.DataMesh`; JAX's psums over
'data'): every rank holds the whole episode's buffer, normalizes its
advantages and cuts each minibatch from it as one process does, and
folds the minibatch's returns into the normalizer. It then takes its
share of the minibatch's rows or chunks (`_share`) and runs the networks
on that; the loss divides by the whole minibatch's mask sums
(`distributed.global_batch`), and the gradients and the loss terms are
summed over the ranks in one flat all-reduce before the clip and Adam,
so the parameters and the metrics are the same on every rank. On a
`(data, model)` mesh the state holds this rank's blocks of the
parameters and moments (`shards`, `parallel/mesh.StateShards`; every
state `init_state` gives is cut): each update gathers the full
parameters over the model group, takes the full gradient, clips it by
its global norm and applies Adam to the blocks. PopArt rescales the
gathered head, which is then cut. `train` and `evaluate_full_logp` take
the state as it is kept; the rollout-time API (`get_actions`,
`get_values`, `act`) the gathered one (`shards.gathered`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.models import actor_critic, popart
from onpolicy_torch.ops import losses, schedules, valuenorm as vn
from onpolicy_torch.parallel import distributed
from onpolicy_torch.parallel import mesh as mesh_lib
from onpolicy_torch.utils import profiling
from onpolicy_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclass
class TrainState:
    actor_params: Any
    critic_params: Any
    actor_opt_state: Any
    critic_opt_state: Any
    vnorm: Optional[vn.ValueNormState]

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


class MAPPO:
    # HAPPO overrides: the joint ratio over heads, and (under PopArt) the
    # stats-only normalizer
    prod_ratio_heads = False
    popart_rescales_head = True

    def __init__(self, cfg, obs_space, share_obs_space, act_space,
                 total_updates: int = 1, num_agents: int = None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.num_agents = num_agents if num_agents is not None \
            else cfg.num_agents
        self.act_space = act_space
        self.actor = actor_critic.Actor(cfg, obs_space, act_space)
        self.critic = actor_critic.Critic(cfg, share_obs_space)
        self.shards = mesh_lib.StateShards(
            mesh, (("actor_params", "actor_opt_state"),
                   ("critic_params", "critic_opt_state")))

        def lr_for(base_lr):
            if cfg.use_linear_lr_decay:
                per_episode = cfg.ppo_epoch * cfg.num_mini_batch
                return lambda count: base_lr * (
                    1.0 - (count // per_episode) / float(max(total_updates, 1)))
            return base_lr

        self.actor_tx = schedules.make_optimizer(
            lr_for(cfg.lr), cfg.opti_eps, cfg.weight_decay,
            cfg.max_grad_norm, cfg.use_max_grad_norm)
        self.critic_tx = schedules.make_optimizer(
            lr_for(cfg.critic_lr), cfg.opti_eps, cfg.weight_decay,
            cfg.max_grad_norm, cfg.use_max_grad_norm)

    # ------------------------------------------------------------------
    def init_state(self, generator: torch.Generator, device) -> TrainState:
        """Parameters drawn from `generator` (a CPU generator), then moved
        to `device`; on a model axis, this rank's blocks."""
        actor_params = self.actor.init(generator, device)
        critic_params = self.critic.init(generator, device)
        vnorm = vn.create(1, device=device) \
            if (self.cfg.use_valuenorm or self.cfg.use_popart) else None
        return self.shards.cut(TrainState(
            actor_params=actor_params, critic_params=critic_params,
            actor_opt_state=self.actor_tx.init(actor_params),
            critic_opt_state=self.critic_tx.init(critic_params),
            vnorm=vnorm))

    # ---- rollout-time API (algorithms/__init__.py) -------------------
    @staticmethod
    def _flat_rows(x, masks, *by):
        """Rows of the leading shape of `masks` [..., 1] → [-1, *by, ...]."""
        return None if x is None else x.reshape(-1, *by,
                                                *x.shape[masks.dim() - 1:])

    def _actor(self, state, obs, rnn_actor, masks, generator,
               available_actions, deterministic, actions=None):
        rows = lambda x: self._flat_rows(x, masks)
        out = self.actor.forward(
            state.actor_params, rows(obs), rows(rnn_actor), rows(masks),
            generator, rows(available_actions), actions=rows(actions),
            deterministic=deterministic)
        return tuple(y.reshape(*masks.shape[:-1], *y.shape[1:]) for y in out)

    def _values(self, critic_params, share_obs, rnn_critic, masks):
        """→ (values, rnn_critic). With `use_critic_dedup` share_obs is the
        same across an env's `num_agents` consecutive rows: the critic
        runs once per env (`Critic.forward_dedup`, on agent 0's row of
        the [N, M, M·D] view, which is not copied) and the rnn states pass
        through."""
        if self.cfg.use_critic_dedup:
            values = self.critic.forward_dedup(critic_params, *(
                self._flat_rows(x, masks, self.num_agents)
                for x in (share_obs, rnn_critic, masks)))
            return values.reshape(masks.shape), rnn_critic
        values, rnn = self.critic.forward(critic_params, *(
            self._flat_rows(x, masks) for x in (share_obs, rnn_critic, masks)))
        return values.reshape(masks.shape), rnn.reshape(rnn_critic.shape)

    def get_actions(self, state: TrainState, share_obs, obs, rnn_actor,
                    rnn_critic, masks, generator, available_actions=None,
                    deterministic=False, actions=None):
        """The actor, then the critic; given `actions`, they are taken
        instead of the draws."""
        actions, log_probs, rnn_actor = self._actor(
            state, obs, rnn_actor, masks, generator, available_actions,
            deterministic, actions)
        values, rnn_critic = self._values(state.critic_params, share_obs,
                                          rnn_critic, masks)
        return values, actions, log_probs, rnn_actor, rnn_critic

    def get_values(self, state: TrainState, share_obs, rnn_critic, masks,
                   obs=None):
        return self._values(state.critic_params, share_obs, rnn_critic,
                            masks)

    def act(self, state: TrainState, obs, rnn_actor, masks, generator=None,
            available_actions=None, deterministic=True, share_obs=None):
        """The actor alone: each head's mode, or under `deterministic`
        false a draw from `generator`."""
        return self._actor(state, obs, rnn_actor, masks, generator,
                           available_actions, deterministic)

    # ---- training ----------------------------------------------------
    def _sample_minibatches(self, buf, adv, generator, perm=None,
                            factor=None):
        cfg = self.cfg
        kw = dict(perm=perm, factor=factor)
        if cfg.use_recurrent_policy:
            return buf_lib.recurrent_minibatches(
                buf, adv, generator, cfg.num_mini_batch, cfg.data_chunk_length,
                **kw)
        if cfg.use_naive_recurrent_policy:
            return buf_lib.naive_recurrent_minibatches(
                buf, adv, generator, cfg.num_mini_batch, **kw)
        return buf_lib.feed_forward_minibatches(buf, adv, generator,
                                                cfg.num_mini_batch, **kw)

    def _share(self, mb: dict) -> dict:
        """This rank's share of a minibatch: a contiguous 1/R of its rows
        (of its chunks or sequences: axis 1 of the [L, B, ...] fields, 0
        of the rnn states)."""
        return distributed.share_rows(mb, self.mesh, self.cfg.is_recurrent)

    def _loss(self, ap, cp, vnorm, mb):
        cfg = self.cfg
        active = mb["active_masks"] if cfg.use_policy_active_masks else None
        if cfg.is_recurrent:      # mb holds [L, B, ...] sequences
            logp, entropy = self.actor.evaluate_seq(
                ap, mb["obs"], mb["rnn_states"], mb["actions"], mb["masks"],
                mb.get("available_actions"), active)
            values = self.critic.forward_seq(
                cp, mb["share_obs"], mb["rnn_states_critic"], mb["masks"])
        else:
            logp, entropy = self.actor.evaluate(
                ap, mb["obs"], mb["rnn_states"], mb["actions"], mb["masks"],
                mb.get("available_actions"), active)
            values, _ = self._values(cp, mb["share_obs"],
                                     mb["rnn_states_critic"], mb["masks"])
        pol_loss, ratio = losses.ppo_policy_loss(
            logp, mb["old_action_log_probs"], mb["advantages"],
            mb["active_masks"], clip_param=cfg.clip_param,
            use_policy_active_masks=cfg.use_policy_active_masks,
            factor=mb.get("factor"), prod_ratio_heads=self.prod_ratio_heads)
        v_loss = losses.value_loss(
            values, mb["value_preds"], mb["returns"], mb["active_masks"],
            vnorm, clip_param=cfg.clip_param,
            use_clipped_value_loss=cfg.use_clipped_value_loss,
            use_huber_loss=cfg.use_huber_loss, huber_delta=cfg.huber_delta,
            use_value_active_masks=cfg.use_value_active_masks)
        total = (pol_loss - entropy * cfg.entropy_coef
                 + v_loss * cfg.value_loss_coef)
        return total, {"policy_loss": pol_loss, "value_loss": v_loss,
                       "dist_entropy": entropy, "ratio": ratio}

    def _update(self, state: TrainState, mb: dict) -> Tuple[TrainState, dict]:
        """One PPO minibatch update (`r_mappo.ppo_update`)."""
        cfg = self.cfg
        vnorm = state.vnorm
        full = self.shards.params(state)
        critic_params = state.critic_params
        returns = mb["returns"].reshape(-1, 1)
        with profiling.span("update.forward", device=True):
            if cfg.use_popart and self.popart_rescales_head:
                v_out, vnorm = popart.update(full["critic_params"]["v_out"],
                                             vnorm, returns)
                full["critic_params"] = {**full["critic_params"],
                                         "v_out": v_out}
                critic_params = self.shards.cut_tree("critic_params",
                                                     full["critic_params"])
            elif cfg.use_popart or cfg.use_valuenorm:
                vnorm = vn.update(vnorm, returns)

            leaf = lambda x: x.detach().requires_grad_(True)
            ap = tree_map(leaf, full["actor_params"])
            cp = tree_map(leaf, full["critic_params"])
            a_leaves, c_leaves = tree_leaves(ap), tree_leaves(cp)
            with torch.enable_grad(), distributed.global_batch(self.mesh):
                total, aux = self._loss(ap, cp, vnorm, self._share(mb))
        with profiling.span("update.backward", device=True), \
                torch.enable_grad():
            grads = torch.autograd.grad(total, a_leaves + c_leaves,
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, a_leaves + c_leaves)]
        grads, aux = distributed.sum_over_ranks(grads, aux, self.mesh)
        with profiling.span("update.optimizer", device=True):
            a_grads, c_grads = grads[:len(a_leaves)], grads[len(a_leaves):]
            aux["actor_grad_norm"] = losses.global_grad_norm(a_grads)
            aux["critic_grad_norm"] = losses.global_grad_norm(c_grads)

            actor_params, a_opt = self.actor_tx.update(
                tree_unflatten(ap, a_grads), state.actor_opt_state,
                state.actor_params, self.shards.cut_grads("actor_params"))
            critic_params, c_opt = self.critic_tx.update(
                tree_unflatten(cp, c_grads), state.critic_opt_state,
                critic_params, self.shards.cut_grads("critic_params"))
        return state.replace(actor_params=actor_params,
                             critic_params=critic_params,
                             actor_opt_state=a_opt, critic_opt_state=c_opt,
                             vnorm=vnorm), aux

    @torch.no_grad()
    def train(self, state: TrainState, buf: buf_lib.RolloutBuffer,
              generator: Optional[torch.Generator] = None,
              factor: Optional[torch.Tensor] = None,
              perms: Optional[Sequence[torch.Tensor]] = None
              ) -> Tuple[TrainState, dict]:
        """Full PPO update over a collected buffer (`r_mappo.train`).
        `factor` is HAPPO's sequential-update weight [T, N, M, 1]. With
        several minibatches each epoch draws its permutation from
        `generator`, or takes `perms[epoch]` (e.g. from a test). Metrics
        are 0-dim tensors, means over all updates."""
        cfg = self.cfg

        def sample(epoch):
            with profiling.span("update.minibatch"):
                return self._sample_minibatches(
                    buf, adv, generator,
                    None if perms is None else perms[epoch], factor)

        with profiling.span("update.minibatch"):
            adv = losses.normalize_advantages(
                buf.advantages, buf.active_masks[:-1]
                if cfg.use_policy_active_masks else None)
        # one minibatch is permutation-free: build it once for all epochs
        mbs = sample(0) if cfg.num_mini_batch == 1 else None
        history = []
        for epoch in range(cfg.ppo_epoch):
            for mb in (mbs if mbs is not None else sample(epoch)):
                state, aux = self._update(state, mb)
                history.append(aux)
        metrics = {k: torch.stack([h[k] for h in history]).mean()
                   for k in history[0]}
        return state, metrics

    # ---- whole-episode log-probs (HAPPO's factor) ---------------------
    @torch.no_grad()
    def evaluate_full_logp(self, state: TrainState,
                           buf: buf_lib.RolloutBuffer) -> torch.Tensor:
        """Log-probs of the buffer's actions under the current actor over
        the whole [T, N·M] episode, the sequence GRU run from the t = 0
        hidden state (on the card: the forward kernel, at T = episode
        length, B = N·M). Returns [T, N, M, heads]."""
        state = self.shards.gathered(state)
        if self.mesh is not None:
            # this rank's block of the envs, the blocks gathered after
            rows = self.mesh.rows(buf.n_rollout_threads)
            mine = buf.replace(**{
                f: getattr(buf, f)[:, rows]
                for f in buf.__dataclass_fields__
                if getattr(buf, f) is not None})
            return distributed.gather_rows(
                self._full_logp(state, mine), 1, self.mesh)
        return self._full_logp(state, buf)

    def _full_logp(self, state, buf):
        T, N, M = buf.T, buf.n_rollout_threads, buf.num_agents
        fold = lambda x: x.reshape(T, N * M, *x.shape[3:])
        avail = (fold(buf.available_actions[:-1])
                 if buf.available_actions is not None else None)
        h0 = buf.rnn_states[0].reshape(N * M, *buf.rnn_states.shape[3:])
        logp, _ = self.actor.evaluate_seq(
            state.actor_params, fold(buf.obs[:-1]), h0, fold(buf.actions),
            fold(buf.masks[:-1]), avail, fold(buf.active_masks[:-1]))
        return logp.reshape(T, N, M, -1)

