"""Device-resident rollout buffer (SharedReplayBuffer parity).

Port of `onpolicy_tpu/buffer.py`: time-major `[T(+1), N, M, ...]` tensors
(N = rollout threads, M = agents) assembled once per episode from the
stacked rollout steps (`from_rollout`), GAE over the whole buffer
(`compute_returns`) and the samplers: chunked BPTT
(`recurrent_minibatches`), whole episodes (`naive_recurrent_minibatches`),
flat rows (`feed_forward_minibatches`) and MAT's rows with the agent axis
kept (`transformer_minibatches`). Each sampler returns a list of
`num_mini_batch` dicts; with one minibatch no permutation is drawn. Each takes a given
permutation (`perm`) in place of a draw, and HAPPO's optional `factor`
[T, N, M, 1], which is cut as the other per-step fields are.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from onpolicy_torch.ops import gae as gae_ops


@dataclass
class RolloutBuffer:
    share_obs: torch.Tensor          # [T+1, N, M, Ds]
    obs: torch.Tensor                # [T+1, N, M, Do]
    rnn_states: torch.Tensor         # [T+1, N, M, L, H]
    rnn_states_critic: torch.Tensor  # [T+1, N, M, L, H]
    actions: torch.Tensor            # [T, N, M, A]
    action_log_probs: torch.Tensor   # [T, N, M, Alp]
    value_preds: torch.Tensor        # [T+1, N, M, 1]
    rewards: torch.Tensor            # [T, N, M, 1]
    masks: torch.Tensor              # [T+1, N, M, 1]
    bad_masks: torch.Tensor          # [T+1, N, M, 1]
    active_masks: torch.Tensor       # [T+1, N, M, 1]
    available_actions: Optional[torch.Tensor] = None  # [T+1, N, M, n_act]
    returns: Optional[torch.Tensor] = None            # [T, N, M, 1]
    advantages: Optional[torch.Tensor] = None         # [T, N, M, 1]

    def replace(self, **kw) -> "RolloutBuffer":
        return dataclasses.replace(self, **kw)

    @property
    def T(self):
        return self.rewards.shape[0]

    @property
    def n_rollout_threads(self):
        return self.rewards.shape[1]

    @property
    def num_agents(self):
        return self.rewards.shape[2]

    def compute_returns(self, next_value, norm_state, *, gamma, gae_lambda,
                        use_gae=True, use_proper_time_limits=False
                        ) -> "RolloutBuffer":
        """GAE / discounted returns over the whole buffer, with the
        bootstrap `next_value` [N, M, 1] in slot T."""
        value_preds = torch.cat([self.value_preds[:-1], next_value[None]], 0)
        returns, advantages = gae_ops.compute_returns(
            self.rewards, value_preds, self.masks, self.bad_masks,
            norm_state, gamma=gamma, gae_lambda=gae_lambda, use_gae=use_gae,
            use_proper_time_limits=use_proper_time_limits)
        return self.replace(value_preds=value_preds, returns=returns,
                            advantages=advantages)


def from_rollout(traj: dict, last: dict) -> RolloutBuffer:
    """Assemble a [T+1]-slotted buffer. `traj` holds, per step t, the
    step's inputs (share_obs/obs/rnn_states/rnn_states_critic/masks/
    active_masks[/available_actions/bad_masks]) and products (actions/
    action_log_probs/value_preds/rewards), each stacked [T, ...]; `last`
    holds the values after the final step (slot T)."""
    cat = lambda k: torch.cat([traj[k], last[k][None]], 0)
    bad = traj.get("bad_masks")
    if bad is None:
        bad = torch.ones_like(traj["masks"])
    last_bad = last.get("bad_masks")
    if last_bad is None:
        last_bad = torch.ones_like(last["masks"])
    return RolloutBuffer(
        share_obs=cat("share_obs"),
        obs=cat("obs"),
        rnn_states=cat("rnn_states"),
        rnn_states_critic=cat("rnn_states_critic"),
        actions=traj["actions"],
        action_log_probs=traj["action_log_probs"],
        value_preds=torch.cat([traj["value_preds"],
                               torch.zeros_like(traj["value_preds"][:1])], 0),
        rewards=traj["rewards"],
        masks=cat("masks"),
        bad_masks=torch.cat([bad, last_bad[None]], 0),
        active_masks=cat("active_masks"),
        available_actions=(cat("available_actions")
                           if traj.get("available_actions") is not None
                           else None),
    )


def _train_fields(buf: RolloutBuffer, advantages: torch.Tensor,
                 factor: Optional[torch.Tensor]) -> dict:
    """The per-step training arrays [T, N, M, ...], with the sampler's
    `advantages` and, when given, HAPPO's `factor`."""
    d = {
        "share_obs": buf.share_obs[:-1],
        "obs": buf.obs[:-1],
        "rnn_states": buf.rnn_states[:-1],
        "rnn_states_critic": buf.rnn_states_critic[:-1],
        "actions": buf.actions,
        "old_action_log_probs": buf.action_log_probs,
        "value_preds": buf.value_preds[:-1],
        "returns": buf.returns,
        "masks": buf.masks[:-1],
        "active_masks": buf.active_masks[:-1],
        "advantages": advantages,
    }
    if buf.available_actions is not None:
        d["available_actions"] = buf.available_actions[:-1]
    if factor is not None:
        d["factor"] = factor
    return d


def _minibatch_index(n: int, num_mini_batch: int, generator, device,
                     perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[num_mini_batch, n // num_mini_batch] indices of a permutation of
    n rows (or chunks), drawn from `generator` unless `perm` is given."""
    if n % num_mini_batch != 0:
        raise ValueError(f"{n} rows not divisible by num_mini_batch "
                         f"{num_mini_batch}")
    if perm is None:
        perm = torch.randperm(n, generator=generator, device=device)
    return perm.to(device).reshape(num_mini_batch, n // num_mini_batch)


def feed_forward_minibatches(buf: RolloutBuffer, advantages: torch.Tensor,
                             generator: Optional[torch.Generator],
                             num_mini_batch: int,
                             perm: Optional[torch.Tensor] = None,
                             factor: Optional[torch.Tensor] = None) -> list:
    """Flat sampler (the reference's `feed_forward_generator`): the T·N·M
    rows in [T, N, M] order, one minibatch of them as they lie (views, no
    copy; the critic dedup relies on that order), or `num_mini_batch`
    equal parts of a permutation drawn from `generator` (or given as
    `perm`). Returns a list of dicts of [mb, ...] rows."""
    d = _train_fields(buf, advantages, factor)
    total = buf.T * buf.n_rollout_threads * buf.num_agents
    flat = {k: x.reshape(total, *x.shape[3:]) for k, x in d.items()}
    if num_mini_batch == 1:
        return [flat]
    idx = _minibatch_index(total, num_mini_batch, generator,
                           buf.rewards.device, perm)
    return [{k: x[i] for k, x in flat.items()} for i in idx]


def transformer_minibatches(buf: RolloutBuffer, advantages: torch.Tensor,
                            generator: Optional[torch.Generator],
                            num_mini_batch: int,
                            perm: Optional[torch.Tensor] = None,
                            factor: Optional[torch.Tensor] = None) -> list:
    """MAT's sampler (the reference's `feed_forward_generator_transformer`):
    the T·N env steps with the agent axis kept intact, as they lie with one
    minibatch, or `num_mini_batch` equal parts of a permutation of the env
    steps (drawn from `generator`, or given as `perm`). Returns a list of
    dicts of [mb, M, ...] rows."""
    d = _train_fields(buf, advantages, factor)
    T, N, M = buf.T, buf.n_rollout_threads, buf.num_agents
    flat = {k: x.reshape(T * N, M, *x.shape[3:]) for k, x in d.items()}
    if num_mini_batch == 1:
        return [flat]
    idx = _minibatch_index(T * N, num_mini_batch, generator,
                           buf.rewards.device, perm)
    return [{k: x[i] for k, x in flat.items()} for i in idx]


def naive_recurrent_minibatches(buf: RolloutBuffer, advantages: torch.Tensor,
                                generator: Optional[torch.Generator],
                                num_mini_batch: int,
                                perm: Optional[torch.Tensor] = None,
                                factor: Optional[torch.Tensor] = None) -> list:
    """Whole-episode sampler (the reference's `naive_recurrent_generator`):
    the N·M env-agent sequences at their full length T, the rnn states
    from t = 0; one minibatch as they lie, or `num_mini_batch` parts of a
    permutation of the N·M sequences (drawn, or given as `perm`). Returns
    a list of dicts of [T, mb, ...] sequences ([mb, ...] rnn states)."""
    d = _train_fields(buf, advantages, factor)
    T, total = buf.T, buf.n_rollout_threads * buf.num_agents
    idx = (None if num_mini_batch == 1 else
           _minibatch_index(total, num_mini_batch, generator,
                            buf.rewards.device, perm))
    out = []
    for i in range(num_mini_batch):
        mb = {}
        for k, x in d.items():
            seq = x.reshape(T, total, *x.shape[3:])
            if idx is not None:
                seq = seq[:, idx[i]]
            mb[k] = seq[0] if k in ("rnn_states", "rnn_states_critic") else seq
        out.append(mb)
    return out


def recurrent_minibatches(buf: RolloutBuffer, advantages: torch.Tensor,
                          generator: Optional[torch.Generator],
                          num_mini_batch: int, data_chunk_length: int,
                          perm: Optional[torch.Tensor] = None,
                          factor: Optional[torch.Tensor] = None) -> list:
    """Chunked-BPTT sampler (the reference's `recurrent_generator`).

    The episodes are laid out env-major ([N, M, T] order) and the flat
    N·M·T stream is cut into L-step windows, dropping the remainder. When
    T % L != 0 (the paper's spread config: T=25, L=10) chunks CROSS
    episode boundaries, a reference quirk kept for parity. Only each
    chunk's first rnn state is gathered. Returns a list of
    `num_mini_batch` dicts of [L, mb, ...] sequences ([mb, ...] for the
    rnn states); with one minibatch the chunks keep their order and no
    permutation is drawn, else `num_mini_batch` parts of a permutation of
    the chunks (drawn, or given as `perm`)."""
    d = _train_fields(buf, advantages, factor)
    T, N, M = buf.T, buf.n_rollout_threads, buf.num_agents
    L = data_chunk_length
    n_chunks = (T * N * M) // L
    device = buf.rewards.device
    idx = (None if num_mini_batch == 1 else
           _minibatch_index(n_chunks, num_mini_batch, generator, device,
                            perm))

    def to_chunks(x):
        # [T,N,M,...] → [N,M,T,...] → flat stream → [n_chunks, L, ...]
        y = x.movedim(0, 2).reshape(N * M * T, *x.shape[3:])
        return y[:n_chunks * L].reshape(n_chunks, L, *x.shape[3:])

    starts = torch.arange(n_chunks, device=device) * L
    t_idx = starts % T
    rem = starts // T
    m_idx = rem % M
    n_idx = rem // M

    out = [{} for _ in range(num_mini_batch)]
    for k, x in d.items():
        if k in ("rnn_states", "rnn_states_critic"):
            h0 = x[t_idx, n_idx, m_idx]                  # [n_chunks, ...]
            for i in range(num_mini_batch):
                out[i][k] = h0 if idx is None else h0[idx[i]]
            continue
        chunks = to_chunks(x)                           # [n_chunks, L, ...]
        for i in range(num_mini_batch):
            c = chunks if idx is None else chunks[idx[i]]
            out[i][k] = c.transpose(0, 1).contiguous()  # [L, mb, ...]
    return out
