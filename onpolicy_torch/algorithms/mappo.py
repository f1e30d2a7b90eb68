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
The recurrent policies' update runs `evaluate_seq` / `forward_seq`
through the sequence GRU, which on the card is the CUDA kernels; the
feed-forward update evaluates flat rows, with `use_critic_dedup` running
the critic once per env. PopArt comes in a later slice (ROADMAP.md) and
raises here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.models import actor_critic
from onpolicy_torch.ops import losses, schedules, valuenorm as vn
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
    def __init__(self, cfg, obs_space, share_obs_space, act_space,
                 total_updates: int = 1):
        if cfg.use_popart:
            raise NotImplementedError(
                "use_popart is not ported yet (ROADMAP.md, Queue 1 item 9)")
        self.cfg = cfg
        self.act_space = act_space
        self.actor = actor_critic.Actor(cfg, obs_space, act_space)
        self.critic = actor_critic.Critic(cfg, share_obs_space)

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
        to `device`."""
        actor_params = self.actor.init(generator, device)
        critic_params = self.critic.init(generator, device)
        vnorm = vn.create(1, device=device) if self.cfg.use_valuenorm else None
        return TrainState(
            actor_params=actor_params, critic_params=critic_params,
            actor_opt_state=self.actor_tx.init(actor_params),
            critic_opt_state=self.critic_tx.init(critic_params),
            vnorm=vnorm)

    # ---- training ----------------------------------------------------
    def _sample_minibatches(self, buf, adv, generator):
        cfg = self.cfg
        if cfg.use_recurrent_policy:
            return buf_lib.recurrent_minibatches(
                buf, adv, generator, cfg.num_mini_batch, cfg.data_chunk_length)
        if cfg.use_naive_recurrent_policy:
            return buf_lib.naive_recurrent_minibatches(
                buf, adv, generator, cfg.num_mini_batch)
        return buf_lib.feed_forward_minibatches(buf, adv, generator,
                                                cfg.num_mini_batch)

    def _critic_flat(self, cp, mb):
        """Values of flat rows [B, 1]. With `use_critic_dedup` the rows are
        [T·N, M] in order (the one-minibatch sampler keeps them so) and go
        through `Critic.forward_dedup`."""
        args = (mb["share_obs"], mb["rnn_states_critic"], mb["masks"])
        if not self.cfg.use_critic_dedup:
            values, _ = self.critic.forward(cp, *args)
            return values
        M = self.cfg.num_agents
        B = mb["share_obs"].shape[0]
        by_env = lambda x: x.reshape(B // M, M, *x.shape[1:])
        return self.critic.forward_dedup(cp, *map(by_env, args)).reshape(B, 1)

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
            values = self._critic_flat(cp, mb)
        pol_loss, ratio = losses.ppo_policy_loss(
            logp, mb["old_action_log_probs"], mb["advantages"],
            mb["active_masks"], clip_param=cfg.clip_param,
            use_policy_active_masks=cfg.use_policy_active_masks)
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
        vnorm = state.vnorm
        if self.cfg.use_valuenorm:
            vnorm = vn.update(vnorm, mb["returns"].reshape(-1, 1))

        leaf = lambda x: x.detach().requires_grad_(True)
        ap = tree_map(leaf, state.actor_params)
        cp = tree_map(leaf, state.critic_params)
        a_leaves, c_leaves = tree_leaves(ap), tree_leaves(cp)
        with torch.enable_grad():
            total, aux = self._loss(ap, cp, vnorm, mb)
            grads = torch.autograd.grad(total, a_leaves + c_leaves,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, a_leaves + c_leaves)]
        a_grads, c_grads = grads[:len(a_leaves)], grads[len(a_leaves):]
        aux = {k: v.detach() for k, v in aux.items()}
        aux["actor_grad_norm"] = losses.global_grad_norm(a_grads)
        aux["critic_grad_norm"] = losses.global_grad_norm(c_grads)

        actor_params, a_opt = self.actor_tx.update(
            tree_unflatten(state.actor_params, a_grads),
            state.actor_opt_state, state.actor_params)
        critic_params, c_opt = self.critic_tx.update(
            tree_unflatten(state.critic_params, c_grads),
            state.critic_opt_state, state.critic_params)
        return state.replace(actor_params=actor_params,
                             critic_params=critic_params,
                             actor_opt_state=a_opt, critic_opt_state=c_opt,
                             vnorm=vnorm), aux

    @torch.no_grad()
    def train(self, state: TrainState, buf: buf_lib.RolloutBuffer,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[TrainState, dict]:
        """Full PPO update over a collected buffer (`r_mappo.train`).
        Metrics are 0-dim tensors, means over all updates."""
        cfg = self.cfg
        adv = losses.normalize_advantages(
            buf.advantages,
            buf.active_masks[:-1] if cfg.use_policy_active_masks else None)
        sample = lambda: self._sample_minibatches(buf, adv, generator)
        # one minibatch is permutation-free: build it once for all epochs
        mbs = sample() if cfg.num_mini_batch == 1 else None
        history = []
        for _ in range(cfg.ppo_epoch):
            for mb in (mbs if mbs is not None else sample()):
                state, aux = self._update(state, mb)
                history.append(aux)
        metrics = {k: torch.stack([h[k] for h in history]).mean()
                   for k in history[0]}
        return state, metrics
