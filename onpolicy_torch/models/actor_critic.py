"""Recurrent actor and critic networks (R_Actor / R_Critic).

Port of `onpolicy_tpu/models/actor_critic.py`: `Actor`/`Critic` hold the
config and spaces and expose init/apply functions over explicit parameter
trees (nested dicts of tensors in the JAX layout). Two layouts:
  * flat batch `[B, ...]` — rollout steps (`forward`) and the
    feed-forward policy's training evaluation (`Actor.evaluate`);
  * sequence `[L, B, ...]` — chunked-BPTT and naive-recurrent training
    through `gru.sequence` (the CUDA kernels on the card).
The base is the MLP, or for image observations (a 3-D obs shape
[C, W, H]) the CNN of `models/cnn.py`. Under `use_bf16` the bases and the
GRU compute in bf16 and the heads in f32 (`act.py` and the value head
take `x.float()`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from onpolicy_torch.models import act as act_layer
from onpolicy_torch.models import cnn, common, gru, mlp
from onpolicy_torch.utils import spaces as sp


def _is_image(obs_shape) -> bool:
    return len(obs_shape) == 3


def _base_init(cfg, obs_shape, generator, device):
    if _is_image(obs_shape):
        return cnn.init(cfg, obs_shape, generator, device)
    return mlp.init(cfg, obs_shape[0], generator, device)


def _features(cfg, obs_shape, params, obs):
    """The base's features of flat rows [B, *obs_shape] → [B, hidden]."""
    if _is_image(obs_shape):
        return cnn.apply(cfg, params["base"], obs)
    return mlp.apply(cfg, params["base"], obs)


def _seq_features(cfg, obs_shape, params, obs):
    """[L, B, *obs_shape] → [L, B, hidden]."""
    L, B = obs.shape[0], obs.shape[1]
    x = _features(cfg, obs_shape, params, obs.reshape(L * B, *obs.shape[2:]))
    return x.reshape(L, B, -1)


class Actor:
    def __init__(self, cfg, obs_space, action_space):
        self.cfg = cfg
        self.obs_space = obs_space
        self.action_space = action_space
        self.obs_shape = sp.obs_shape(obs_space)

    def init(self, generator: torch.Generator, device):
        cfg = self.cfg
        params = {"base": _base_init(cfg, self.obs_shape, generator, device),
                  "act": act_layer.init(cfg, self.action_space,
                                        cfg.hidden_size, generator, device)}
        if cfg.is_recurrent:
            params["rnn"] = gru.init(cfg, cfg.hidden_size, generator, device)
        return params

    def forward(self, params, obs, rnn_states, masks, generator,
                available_actions=None, actions=None, deterministic=False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """obs [B, ...] → (actions, log_probs, new_rnn_states). Given
        `actions`, they are taken instead of a draw; `deterministic` takes
        the mode of each head."""
        x = _features(self.cfg, self.obs_shape, params, obs)
        if self.cfg.is_recurrent:
            x, rnn_states = gru.step(self.cfg, params["rnn"], x, rnn_states,
                                     masks)
        actions, log_probs = act_layer.sample(
            self.cfg, params["act"], self.action_space, x, generator,
            available_actions, actions, deterministic)
        return actions, log_probs, rnn_states

    def evaluate(self, params, obs, rnn_states, action, masks,
                 available_actions=None, active_masks=None):
        """Flat-batch evaluation (feed-forward, or one recurrent step):
        obs [B, ...] → ([B, 1] log-probs, scalar entropy)."""
        x = _features(self.cfg, self.obs_shape, params, obs)
        if self.cfg.is_recurrent:
            x, _ = gru.step(self.cfg, params["rnn"], x, rnn_states, masks)
        return act_layer.evaluate(self.cfg, params["act"], self.action_space,
                                  x, action, available_actions, active_masks)

    def evaluate_seq(self, params, obs, rnn_states, action, masks,
                     available_actions=None, active_masks=None):
        """obs/action/masks [L, B, ...], rnn_states [B, N, H] at the chunk
        start. Returns ([L, B, 1] log-probs, scalar entropy)."""
        L, B = obs.shape[0], obs.shape[1]
        x = _seq_features(self.cfg, self.obs_shape, params, obs)
        if self.cfg.is_recurrent:
            x, _ = gru.sequence(self.cfg, params["rnn"], x, rnn_states, masks)
        flat = lambda a: None if a is None else a.reshape(L * B, *a.shape[2:])
        lp, ent = act_layer.evaluate(
            self.cfg, params["act"], self.action_space, x.reshape(L * B, -1),
            flat(action), flat(available_actions), flat(active_masks))
        return lp.reshape(L, B, -1), ent

    def evaluate_trpo(self, params, obs, rnn_states, action, masks,
                      available_actions=None, active_masks=None):
        """HATRPO's flat-batch evaluation: (log_probs, entropy, mu, std,
        all_probs) of `act.evaluate_trpo`."""
        x = _features(self.cfg, self.obs_shape, params, obs)
        if self.cfg.is_recurrent:
            x, _ = gru.step(self.cfg, params["rnn"], x, rnn_states, masks)
        return act_layer.evaluate_trpo(self.cfg, params["act"],
                                       self.action_space, x, action,
                                       available_actions, active_masks)

    def evaluate_trpo_seq(self, params, obs, rnn_states, action, masks,
                          available_actions=None, active_masks=None):
        """Sequence-layout TRPO evaluation: obs/action/masks [L, B, ...],
        rnn_states [B, N, H] at the chunk start; the outputs flat
        [L·B, ...] (the reference's trpo path works on flat rows)."""
        L, B = obs.shape[0], obs.shape[1]
        x = _seq_features(self.cfg, self.obs_shape, params, obs)
        if self.cfg.is_recurrent:
            x, _ = gru.sequence(self.cfg, params["rnn"], x, rnn_states, masks)
        flat = lambda a: None if a is None else a.reshape(L * B, *a.shape[2:])
        return act_layer.evaluate_trpo(
            self.cfg, params["act"], self.action_space, x.reshape(L * B, -1),
            flat(action), flat(available_actions), flat(active_masks))


class Critic:
    def __init__(self, cfg, cent_obs_space):
        self.cfg = cfg
        self.obs_shape = sp.obs_shape(cent_obs_space)

    def init(self, generator: torch.Generator, device):
        cfg = self.cfg
        params = {"base": _base_init(cfg, self.obs_shape, generator, device),
                  "v_out": common.linear_init(
                      cfg.hidden_size, 1, gain=1.0,
                      use_orthogonal=cfg.use_orthogonal,
                      generator=generator, device=device)}
        if cfg.is_recurrent:
            params["rnn"] = gru.init(cfg, cfg.hidden_size, generator, device)
        return params

    def forward(self, params, cent_obs, rnn_states, masks):
        """[B, ...] → (values [B, 1], new_rnn_states). Value head in f32."""
        x = _features(self.cfg, self.obs_shape, params, cent_obs)
        if self.cfg.is_recurrent:
            x, rnn_states = gru.step(self.cfg, params["rnn"], x, rnn_states,
                                     masks)
        return common.linear_apply(params["v_out"], x.float()), rnn_states

    def forward_dedup(self, params, cent_obs, rnn_states, masks):
        """`use_critic_dedup`: inputs [..., M, ...] whose centralized
        observation is the same for every one of an env's M agents →
        values [..., M, 1]. The critic runs on agent 0's row and the value
        is broadcast to the M agents, which is exact (autograd sums the
        agents' cotangents through the broadcast). The critic is
        feed-forward, so the rnn states pass through unused."""
        lead = cent_obs.dim() - 2       # the agents' axis
        pick = lambda x: x.select(lead, 0)
        v, _ = self.forward(params, pick(cent_obs), pick(rnn_states),
                            pick(masks))
        return v.unsqueeze(lead).expand(*cent_obs.shape[:lead + 1], 1)

    def forward_seq(self, params, cent_obs, rnn_states, masks):
        """[L, B, ...] → values [L, B, 1]."""
        x = _seq_features(self.cfg, self.obs_shape, params, cent_obs)
        if self.cfg.is_recurrent:
            x, _ = gru.sequence(self.cfg, params["rnn"], x, rnn_states, masks)
        return common.linear_apply(params["v_out"], x.float())
