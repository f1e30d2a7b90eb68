"""Plain simple_spread (MPE) in float64: one physics step, the reward and
the observation, written from the reference environment's semantics
(`multiagent/core.py`, `scenarios/simple_spread.py`).

World: M agents of size 0.15 and mass 1 that collide with each other,
K landmarks that neither move nor collide, damping 0.25, dt 0.1, contact
force 100 with margin 1e-3, discrete actions [noop, +x, -x, +y, -y] at
sensitivity 5. Reward, shared by all agents: M * (-sum over landmarks of
the nearest agent's distance) - the number of (ordered) agent pairs
closer than 0.3, each agent's pair with itself included. Observation of
agent i: own velocity, own position, the landmarks relative to it, the
other agents relative to it, the other agents' (silent, zero)
communication.

The state is read back from the observations: every agent sees its own
velocity and position, and agent 0 sees every landmark.
"""
from __future__ import annotations

import torch

SIZE, DAMPING, DT, SENS = 0.15, 0.25, 0.1, 5.0
CONTACT_FORCE, CONTACT_MARGIN = 100.0, 1e-3
# a pair whose distance lies this close to the collision threshold may
# count either way between float32 and float64 arithmetic
AMBIGUOUS = 1e-5


def state_from_obs(obs, K):
    """obs [N, M, D] -> (pos [N, M, 2], vel [N, M, 2], landmarks [N, K, 2])."""
    vel, pos = obs[..., 0:2], obs[..., 2:4]
    lm = obs[:, 0, 4:4 + 2 * K].reshape(-1, K, 2) + pos[:, 0, None]
    return pos, vel, lm


def step(pos, vel, actions):
    """One physics step of the agents. actions [N, M] in 0..4."""
    a = actions.long()
    u = torch.stack([(a == 1).double() - (a == 2).double(),
                     (a == 3).double() - (a == 4).double()], -1) * SENS
    delta = pos[:, :, None] - pos[:, None]                      # [N, M, M, 2]
    dist = torch.sqrt(torch.clamp_min(delta.square().sum(-1), 1e-12))
    x = -(dist - 2 * SIZE) / CONTACT_MARGIN
    pen = torch.logaddexp(torch.zeros_like(x), x) * CONTACT_MARGIN
    f = CONTACT_FORCE * delta / dist[..., None] * pen[..., None]
    M = pos.shape[1]
    off = ~torch.eye(M, dtype=torch.bool, device=pos.device)
    force = (f * off[None, :, :, None]).sum(2) + u
    vel = vel * (1 - DAMPING) + force * DT
    return pos + vel * DT, vel


def reward(pos, lm):
    """-> (shared reward [N], ambiguous [N]: a pair within AMBIGUOUS of
    the collision threshold)."""
    d_lm = torch.sqrt(torch.clamp_min(
        (pos[:, :, None] - lm[:, None]).square().sum(-1), 1e-12))
    cover = -d_lm.min(1).values.sum(-1)
    d = torch.sqrt(torch.clamp_min(
        (pos[:, :, None] - pos[:, None]).square().sum(-1), 1e-12))
    M = pos.shape[1]
    collisions = (d < 2 * SIZE).double().sum((1, 2))
    ambiguous = ((d - 2 * SIZE).abs() < AMBIGUOUS).any(-1).any(-1)
    return M * cover - collisions, ambiguous


def observe(pos, vel, lm):
    """-> obs [N, M, 4 + 2K + 4(M-1)]."""
    N, M = pos.shape[:2]
    out = []
    for i in range(M):
        others = [j for j in range(M) if j != i]
        out.append(torch.cat([
            vel[:, i], pos[:, i], (lm - pos[:, i, None]).reshape(N, -1),
            (pos[:, others] - pos[:, i, None]).reshape(N, -1),
            torch.zeros(N, 2 * (M - 1), dtype=pos.dtype, device=pos.device),
        ], -1))
    return torch.stack(out, 1)


def check_rollout(obs, actions, rewards, masks, K, episode_length):
    """One rollout of T steps as the buffer holds it: obs [T+1, N, M, D],
    actions [T, N, M, 1], rewards [T, N, M, 1], masks [T+1, N, M, 1]
    (float32, any device). Steps every world from its observed state with
    the taken actions and compares: the next observation where the episode
    goes on, and the reward everywhere. -> the widest gaps, counts and
    whether the reset observations are fresh worlds."""
    obs, rewards = obs.double(), rewards.double()
    T = actions.shape[0]
    obs_gap = torch.zeros((), dtype=torch.float64, device=obs.device)
    rew_gap = torch.zeros_like(obs_gap)
    skipped = 0
    fresh_ok = True
    mask_ok = True
    for t in range(T):
        pos, vel, lm = state_from_obs(obs[t], K)
        pos2, vel2 = step(pos, vel, actions[t, ..., 0])
        r, amb = reward(pos2, lm)
        gap = (rewards[t, ..., 0] - r[:, None]).abs().amax(-1)
        rew_gap = torch.maximum(rew_gap, torch.where(amb, 0.0, gap).max())
        skipped += int(amb.sum())
        ends = (t + 1) % episode_length == 0
        if not ends:
            obs_gap = torch.maximum(
                obs_gap, (observe(pos2, vel2, lm) - obs[t + 1]).abs().max())
        else:
            p, v, l = state_from_obs(obs[t + 1], K)
            fresh_ok &= bool((v == 0).all() and (p.abs() <= 1).all()
                             and (l.abs() <= 0.8 + 1e-6).all())
        want = 0.0 if ends else 1.0
        mask_ok &= bool((masks[t + 1] == want).all())
    return {"obs_gap": float(obs_gap), "reward_gap": float(rew_gap),
            "ambiguous_steps": skipped, "resets_fresh": fresh_ok,
            "masks_ok": mask_ok}
