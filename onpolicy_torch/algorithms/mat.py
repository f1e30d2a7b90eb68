"""MAT: Multi-Agent Transformer policy and trainer (mat, mat_dec).

Port of `onpolicy_tpu/algorithms/mat.py` (the reference's
`transformer_policy.py` + `mat_trainer.py`): one transformer, one
optimizer over all its parameters (clip → Adam(lr, eps) [→ weight decay],
`ops/schedules.py`), the joint loss policy − entropy·coef + value·coef,
always the transformer sampler (agent axis kept intact), ValueNorm for
the targets, and linear lr decay counted per update. It has the
trainers' rollout-time interface (`algorithms/__init__.py`; rnn-state
arguments pass through untouched, `transformer_policy.py:117-119`). The
critic is the encoder's value head; it reads obs, or the centralized
state under `encode_state` (`critic_reads`). MAT has no PopArt branch: it
normalizes its targets only under `use_valuenorm` (JAX `mat.py:75, 121`),
whatever `use_popart` says. Box action spaces decode with the
transformer's gaussian head; their log-probs and entropies are per action
dimension. Over a data mesh (`mesh`) each rank trains on its share of
every minibatch's env steps and the gradients are summed, as in
`algorithms/mappo.py`, whose `update.*` profiling spans `train` and
`_update` share.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.models import transformer as tfm
from onpolicy_torch.ops import losses, schedules, valuenorm as vn
from onpolicy_torch.parallel import distributed
from onpolicy_torch.parallel import mesh as mesh_lib
from onpolicy_torch.utils import profiling
from onpolicy_torch.utils import spaces as sp
from onpolicy_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclass
class MATTrainState:
    params: Any
    opt_state: Any
    vnorm: Optional[vn.ValueNormState]

    def replace(self, **kw) -> "MATTrainState":
        return dataclasses.replace(self, **kw)


class MAT:
    @property
    def critic_reads(self):
        return "share_obs" if self.cfg.encode_state else "obs"

    def __init__(self, cfg, obs_space, share_obs_space, act_space,
                 total_updates: int = 1, num_agents: int = None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.shards = mesh_lib.StateShards(mesh, (("params", "opt_state"),))
        self.num_agents = num_agents if num_agents is not None \
            else cfg.num_agents
        self.obs_dim = sp.obs_shape(obs_space)[0]
        self.share_obs_dim = sp.obs_shape(share_obs_space)[0]
        if isinstance(act_space, sp.Discrete):
            action_dim, action_type = act_space.n, "Discrete"
        elif isinstance(act_space, sp.Box):
            action_dim, action_type = act_space.shape[0], "Box"
        else:
            raise TypeError(f"MAT supports Discrete/Box, got {act_space}")
        self.act_space = act_space
        self.mcfg = tfm.MATConfig(
            self.num_agents, action_dim, cfg.n_block, cfg.n_embd, cfg.n_head,
            action_type, cfg.dec_actor, cfg.share_actor, cfg.encode_state)

        lr = cfg.lr
        if cfg.use_linear_lr_decay:
            per_episode = cfg.ppo_epoch * cfg.num_mini_batch
            lr = lambda count: cfg.lr * (
                1.0 - (count // per_episode) / float(max(total_updates, 1)))
        self.tx = schedules.make_optimizer(
            lr, cfg.opti_eps, cfg.weight_decay, cfg.max_grad_norm,
            cfg.use_max_grad_norm)

    def init_state(self, generator: torch.Generator, device) -> MATTrainState:
        """Parameters drawn from `generator` (a CPU generator), then moved
        to `device`; on a model axis, this rank's blocks."""
        enc_dim = self.share_obs_dim if self.cfg.encode_state \
            else self.obs_dim
        params = tfm.mat_init(self.mcfg, self.obs_dim, generator, device,
                              encoder_dim=enc_dim)
        vnorm = vn.create(1, device=device) if self.cfg.use_valuenorm \
            else None
        return self.shards.cut(MATTrainState(
            params=params, opt_state=self.tx.init(params), vnorm=vnorm))

    # ---- rollout-time API (algorithms/__init__.py) -------------------
    def _fold(self, x):
        """Rows [..., D] → [N, M, D] (an env's M agents consecutive)."""
        return None if x is None else x.reshape(-1, self.num_agents,
                                                x.shape[-1])

    def get_actions(self, state: MATTrainState, share_obs, obs, rnn_actor,
                    rnn_critic, masks, generator, available_actions=None,
                    deterministic=False, actions=None):
        """One autoregressive decode; given `actions` (drawn elsewhere),
        they are taken instead of the draws. Under encode_state the
        encoder reads `share_obs`."""
        enc_in = self._fold(share_obs) if self.cfg.encode_state else None
        acts, logp, values = tfm.autoregressive_act(
            self.mcfg, state.params, self._fold(obs), generator,
            self._fold(available_actions), deterministic, enc_in=enc_in,
            actions=self._fold(actions))
        rows = lambda y: y.reshape(*obs.shape[:-1], y.shape[-1])
        return rows(values), rows(acts), rows(logp), rnn_actor, rnn_critic

    def get_values(self, state: MATTrainState, share_obs, rnn_critic, masks,
                   obs=None):
        """The encoder's value head over what `critic_reads` names (the
        reference zeroes and ignores the centralized state,
        ma_transformer.py:237-239)."""
        x = share_obs if self.critic_reads == "share_obs" else obs
        values = tfm.get_values(self.mcfg, state.params, self._fold(x))
        return values.reshape(*x.shape[:-1], 1), rnn_critic

    def act(self, state: MATTrainState, obs, rnn_actor, masks,
            generator=None, available_actions=None, deterministic=True,
            share_obs=None):
        _, acts, logp, rnn_actor, _ = self.get_actions(
            state, share_obs, obs, rnn_actor, None, masks, generator,
            available_actions, deterministic)
        return acts, logp, rnn_actor

    # ---- training ----------------------------------------------------
    def _loss(self, params, vnorm, mb):
        cfg = self.cfg
        enc_in = mb["share_obs"] if cfg.encode_state else None
        logp, values, entropy = tfm.parallel_act(
            self.mcfg, params, mb["obs"], mb["actions"],
            mb.get("available_actions"), enc_in=enc_in)
        am = mb["active_masks"]
        ent = losses.masked_mean(
            entropy, am if cfg.use_policy_active_masks else None)
        pol_loss, ratio = losses.ppo_policy_loss(
            logp, mb["old_action_log_probs"], mb["advantages"], am,
            clip_param=cfg.clip_param,
            use_policy_active_masks=cfg.use_policy_active_masks)
        v_loss = losses.value_loss(
            values, mb["value_preds"], mb["returns"], am, vnorm,
            clip_param=cfg.clip_param,
            use_clipped_value_loss=cfg.use_clipped_value_loss,
            use_huber_loss=cfg.use_huber_loss, huber_delta=cfg.huber_delta,
            use_value_active_masks=cfg.use_value_active_masks)
        total = pol_loss - ent * cfg.entropy_coef + v_loss * cfg.value_loss_coef
        return total, {"policy_loss": pol_loss, "value_loss": v_loss,
                       "dist_entropy": ent, "ratio": ratio}

    def _update(self, state: MATTrainState, mb: dict):
        with profiling.span("update.forward", device=True):
            vnorm = state.vnorm
            if self.cfg.use_valuenorm:
                vnorm = vn.update(vnorm, mb["returns"].reshape(-1, 1))
            params = tree_map(lambda x: x.detach().requires_grad_(True),
                              self.shards.params(state)["params"])
            leaves = tree_leaves(params)
            with torch.enable_grad(), distributed.global_batch(self.mesh):
                total, aux = self._loss(params, vnorm,
                                        distributed.share_rows(mb, self.mesh,
                                                               False))
        with profiling.span("update.backward", device=True), \
                torch.enable_grad():
            grads = torch.autograd.grad(total, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, leaves)]
        grads, aux = distributed.sum_over_ranks(grads, aux, self.mesh)
        with profiling.span("update.optimizer", device=True):
            aux["grad_norm"] = losses.global_grad_norm(grads)
            new_params, opt_state = self.tx.update(
                tree_unflatten(params, grads), state.opt_state, state.params,
                self.shards.cut_grads("params"))
        return state.replace(params=new_params, opt_state=opt_state,
                             vnorm=vnorm), aux

    @torch.no_grad()
    def train(self, state: MATTrainState, buf: buf_lib.RolloutBuffer,
              generator: Optional[torch.Generator] = None,
              perms: Optional[Sequence[torch.Tensor]] = None):
        """ppo_epoch × num_mini_batch updates (`mat_trainer.train`). With
        several minibatches each epoch draws its permutation of the env
        steps from `generator`, or takes `perms[epoch]`. Metrics are 0-dim
        tensors, means over all updates."""
        cfg = self.cfg

        def sample(epoch):
            with profiling.span("update.minibatch"):
                return buf_lib.transformer_minibatches(
                    buf, adv, generator, cfg.num_mini_batch,
                    None if perms is None else perms[epoch])

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
        return state, {k: torch.stack([h[k] for h in history]).mean()
                       for k in history[0]}
