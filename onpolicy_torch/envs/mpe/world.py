"""Batched MPE particle physics on torch tensors.

Port of `onpolicy_tpu/envs/mpe/world.py`. The JAX engine steps one world
and is vmapped over env instances; here every array carries the env axis
N in front (`agent_pos [N, M, 2]`) and the step is written batched. The
dtype follows the state (float32 in training, float64 in the exactness
tests).

Semantics kept (quirks included):
  * action force = (mass·accel if accel set else mass) · u, u already
    scaled by the sensitivity in the env layer;
  * pairwise softmax-penetration collision forces with contact_force=100
    and contact_margin=1e-3, mass-ratio weighting for movable pairs. The
    penetration is `logaddexp(0, x)`, not `F.softplus`, which turns linear
    above its threshold and would break the float64 comparison;
  * wall contact forces on agents (`_wall_forces`): the same softplus
    penetration against a wall's face, its ends rounded by the agent's
    size; ghost agents pass through soft walls;
  * action noise u_noise·ε added to the action force, comm noise
    c_noise·ε to the comm action, ε standard normal: the draws
    ([N, M, 2] and [N, M, dim_c]) come in through `physics_step`'s `noise`,
    so a test can give it the JAX package's;
  * semi-implicit Euler: v ← v·(1−damping) + F/m·dt; speed clamp with the
    EPS floor under the square root; p ← p + v·dt;
  * comm state: zeros when silent, else the comm action (+ noise).

Entity order: agents then landmarks. Static metadata lives in `WorldSpec`,
the dynamic state in `WorldState`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

EPS = 1e-12


@dataclass(frozen=True)
class WallSpec:
    orient: str          # 'H' or 'V'
    axis_pos: float
    endpoints: Tuple[float, float]
    width: float = 0.1
    hard: bool = True


@dataclass(frozen=True)
class WorldSpec:
    n_agents: int
    n_landmarks: int
    dim_c: int
    world_length: int
    agent_movable: Tuple[bool, ...]
    agent_silent: Tuple[bool, ...]
    agent_collide: Tuple[bool, ...]
    agent_size: Tuple[float, ...]
    agent_accel: Tuple[Optional[float], ...]
    agent_max_speed: Tuple[Optional[float], ...]
    agent_u_noise: Tuple[Optional[float], ...] = None
    agent_c_noise: Tuple[Optional[float], ...] = None
    agent_mass: Tuple[float, ...] = None
    agent_ghost: Tuple[bool, ...] = None
    agent_adversary: Tuple[bool, ...] = None
    landmark_collide: Tuple[bool, ...] = None
    landmark_movable: Tuple[bool, ...] = None
    landmark_size: Tuple[float, ...] = None
    landmark_mass: Tuple[float, ...] = None
    walls: Tuple[WallSpec, ...] = ()
    damping: float = 0.25
    dt: float = 0.1
    contact_force: float = 1e2
    contact_margin: float = 1e-3

    def __post_init__(self):
        def default(name, value):
            if getattr(self, name) is None:
                object.__setattr__(self, name, value)
        M, K = self.n_agents, self.n_landmarks
        default("agent_u_noise", (None,) * M)
        default("agent_c_noise", (None,) * M)
        default("agent_mass", (1.0,) * M)
        default("agent_ghost", (False,) * M)
        default("agent_adversary", (False,) * M)
        default("landmark_collide", (False,) * K)
        default("landmark_movable", (False,) * K)
        default("landmark_size", (0.05,) * K)
        default("landmark_mass", (1.0,) * K)

    @property
    def n_entities(self) -> int:
        return self.n_agents + self.n_landmarks

    def entity_arrays(self):
        """(sizes[E], collide[E], movable[E], mass[E]) as numpy."""
        sizes = np.array(self.agent_size + self.landmark_size, np.float64)
        collide = np.array(self.agent_collide + self.landmark_collide, bool)
        movable = np.array(self.agent_movable + self.landmark_movable, bool)
        mass = np.array(self.agent_mass + self.landmark_mass, np.float64)
        return sizes, collide, movable, mass


@dataclass
class WorldState:
    """A batch of N worlds."""
    agent_pos: torch.Tensor       # [N, M, 2]
    agent_vel: torch.Tensor       # [N, M, 2]
    agent_comm: torch.Tensor      # [N, M, max(dim_c, 1)]
    landmark_pos: torch.Tensor    # [N, K, 2]
    landmark_vel: torch.Tensor    # [N, K, 2]
    t: torch.Tensor               # [N] int32 step counter
    extras: dict = field(default_factory=dict)  # scenario state (goals…)

    def replace(self, **kw) -> "WorldState":
        return dataclasses.replace(self, **kw)

    def tensors(self) -> dict:
        """Field name → tensor (extras flattened as `extras.<key>`)."""
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
             if f.name != "extras"}
        d.update({f"extras.{k}": v for k, v in self.extras.items()})
        return d

    @classmethod
    def from_tensors(cls, d: dict) -> "WorldState":
        extras = {k[7:]: v for k, v in d.items() if k.startswith("extras.")}
        return cls(**{k: v for k, v in d.items()
                      if not k.startswith("extras.")}, extras=extras)


def select(done: torch.Tensor, new: WorldState, old: WorldState) -> WorldState:
    """Per env: `new` where done [N] is true, else `old`."""
    def pick(a, b):
        return torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
    n, o = new.tensors(), old.tensors()
    return WorldState.from_tensors({k: pick(n[k], o[k]) for k in o})


def _const(x, like: torch.Tensor):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _collision_forces(spec: WorldSpec, pos: torch.Tensor) -> torch.Tensor:
    """Pairwise contact forces. pos: [N, E, 2] → net force [N, E, 2]."""
    sizes, collide, movable, mass = spec.entity_arrays()
    if not collide.any():
        return torch.zeros_like(pos)
    delta = pos[:, :, None, :] - pos[:, None, :, :]            # a - b
    dist = torch.sqrt(torch.clamp_min(delta.square().sum(-1), EPS))
    dist_min = _const(sizes[:, None] + sizes[None, :], pos)
    k = spec.contact_margin
    x = -(dist - dist_min) / k
    penetration = torch.logaddexp(torch.zeros_like(x), x) * k
    force = spec.contact_force * delta / dist[..., None] * penetration[..., None]

    # pair validity: both collide, at least one movable, not self; the
    # force on a from (a, b) is weighted m_b/m_a when both are movable,
    # 1 otherwise, and 0 when a is immovable
    valid = (collide[:, None] & collide[None, :]
             & (movable[:, None] | movable[None, :]))
    valid &= ~np.eye(spec.n_entities, dtype=bool)
    both = movable[:, None] & movable[None, :]
    ratio = np.where(both, mass[None, :] / mass[:, None], 1.0)
    w = _const(np.where(valid & movable[:, None], ratio, 0.0), pos)
    return (w[..., None] * force).sum(2)


def _wall_forces(spec: WorldSpec, pos: torch.Tensor) -> torch.Tensor:
    """Wall contact forces on agents. pos: [N, M, 2] → [N, M, 2]."""
    if not spec.walls:
        return torch.zeros_like(pos)
    s = _const(np.array(spec.agent_size, np.float64), pos)         # [M]
    ghost = np.array(spec.agent_ghost, bool)
    k = spec.contact_margin
    total = torch.zeros_like(pos)
    for wall in spec.walls:
        prll, perp = (0, 1) if wall.orient == "H" else (1, 0)
        p_prll, p_perp = pos[..., prll], pos[..., perp]             # [N, M]
        lo, hi = wall.endpoints
        beyond = (p_prll < lo - s) | (p_prll > hi + s)
        below, above = p_prll < lo, p_prll > hi
        past_end = (torch.where(below, p_prll - lo, 0.0)
                    + torch.where(above, p_prll - hi, 0.0))
        partial = below | above
        theta = torch.where(partial,
                            torch.arcsin(torch.clamp(past_end / s, -1.0, 1.0)),
                            0.0)
        dist_min = torch.where(partial, torch.cos(theta) * s, s) \
            + 0.5 * wall.width
        delta = p_perp - wall.axis_pos
        dist = torch.clamp_min(delta.abs(), EPS)
        x = -(dist - dist_min) / k
        penetration = torch.logaddexp(torch.zeros_like(x), x) * k
        fmag = spec.contact_force * delta / dist * penetration
        f = torch.zeros_like(pos)
        f[..., perp] = torch.cos(theta) * fmag
        f[..., prll] = torch.sin(theta) * fmag.abs()
        passes = _const(ghost & (not wall.hard), pos).bool()       # [M]
        total = total + torch.where((~beyond & ~passes)[..., None], f, 0.0)
    return total


def _noise_scale(noise_per_agent) -> np.ndarray:
    return np.array([n if n else 0.0 for n in noise_per_agent], np.float64)


def has_noise(spec: WorldSpec) -> Tuple[bool, bool]:
    """(action noise, comm noise): whether a step needs each draw."""
    return (bool(_noise_scale(spec.agent_u_noise).any()),
            spec.dim_c > 0 and bool(_noise_scale(spec.agent_c_noise).any()))


def physics_step(spec: WorldSpec, state: WorldState, u: torch.Tensor,
                 c: torch.Tensor, noise: Optional[dict] = None) -> WorldState:
    """One step of N worlds. u: [N, M, 2] sensitivity-scaled control;
    c: [N, M, dim_c]. `noise` holds the standard normal draws the spec's
    noise needs (`has_noise`): "u" [N, M, 2] and "c" [N, M, dim_c]."""
    M = spec.n_agents
    like = state.agent_pos
    need_u, need_c = has_noise(spec)
    if (need_u or need_c) and noise is None:
        raise ValueError("this world has action or comm noise: pass its "
                         "standard normal draws as `noise`")
    accel = np.array([a if a is not None else np.nan
                      for a in spec.agent_accel], np.float64)
    mass_a = np.array(spec.agent_mass, np.float64)
    movable_a = np.array(spec.agent_movable, bool)
    factor = np.where(np.isnan(accel), mass_a, mass_a * accel)
    action_force = _const(factor, like)[:, None] * u
    if need_u:
        action_force = action_force + noise["u"].to(like.dtype) * _const(
            _noise_scale(spec.agent_u_noise), like)[:, None]
    action_force = torch.where(_const(movable_a, like).bool()[:, None],
                               action_force, 0.0)

    pos = torch.cat([state.agent_pos, state.landmark_pos], 1)
    vel = torch.cat([state.agent_vel, state.landmark_vel], 1)
    force = _collision_forces(spec, pos)
    force = torch.cat([force[:, :M] + action_force
                       + _wall_forces(spec, state.agent_pos), force[:, M:]], 1)

    _, _, movable, mass = spec.entity_arrays()
    new_vel = vel * (1.0 - spec.damping) + (force / _const(mass, like)[:, None]) * spec.dt
    max_speed = np.array(
        [s if s is not None else np.nan for s in spec.agent_max_speed]
        + [np.nan] * spec.n_landmarks, np.float64)
    if not np.isnan(max_speed).all():
        speed = torch.sqrt(torch.clamp_min(new_vel.square().sum(-1), EPS))
        clamp = (_const(~np.isnan(max_speed), like).bool()
                 & (speed > _const(np.nan_to_num(max_speed, nan=np.inf), like)))
        scale = torch.where(
            clamp, _const(np.nan_to_num(max_speed, nan=1.0), like) / speed, 1.0)
        new_vel = new_vel * scale[..., None]
    mov = _const(movable, like).bool()[:, None]
    new_vel = torch.where(mov, new_vel, vel)
    new_pos = torch.where(mov, pos + new_vel * spec.dt, pos)

    silent = np.array(spec.agent_silent, bool)
    if spec.dim_c > 0:
        if need_c:
            c = c + noise["c"].to(like.dtype) * _const(
                _noise_scale(spec.agent_c_noise), like)[:, None]
        comm = torch.where(_const(silent, like).bool()[:, None], 0.0, c)
    else:
        comm = state.agent_comm

    return state.replace(
        agent_pos=new_pos[:, :M], agent_vel=new_vel[:, :M],
        landmark_pos=new_pos[:, M:], landmark_vel=new_vel[:, M:],
        agent_comm=comm, t=state.t + 1)
