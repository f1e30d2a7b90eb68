"""Device-resident Hanabi fleet: N lockstep games as one batched state.

Port of `onpolicy_tpu/envs/hanabi/jax_fleet.py`, with the observation
composition of `HanabiVecEnv` (the reference's `Hanabi_Env.py:305-311`):
obs = canonical(cur) + agent-turn one-hot; share = own-hand(cur) +
canonical(cur) + turn, or all players' views + turn under
`use_obs_instead_of_state`; finished games present zeroed rows and zero
availability; action −1 = no-op; reward = score delta broadcast to the
players.

Two APIs over the engine (`torch_engine.py`):
  * pure: `reset_states` / `observe` / `pure_step` / `masked_reset` on
    device tensors, which the runner's episode loop composes with no host
    transfer;
  * protocol: numpy `reset(mask)` / `step(actions)`, as HanabiVecEnv's.
Decks are shuffled on the fleet's device from its generator;
`reset_states` and `masked_reset` also take decks [N, deck_len], so that a
test can hand two implementations the same deals.

`CppHanabiFleet` gives the C++ engine's fleet (`hanabi_env.HanabiVecEnv`)
the same two APIs, so that the runner's device round drives either engine.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from onpolicy_torch.envs.hanabi import torch_engine as te
from onpolicy_torch.envs.hanabi.hanabi_env import PRESETS
from onpolicy_torch.utils import spaces as sp


class TorchHanabiFleet:
    def __init__(self, hanabi_name: str, num_agents: int, n_envs: int,
                 device, generator: torch.Generator,
                 use_obs_instead_of_state: bool = False):
        if hanabi_name not in PRESETS:
            raise ValueError(f"unknown hanabi preset {hanabi_name!r}; "
                             f"known: {sorted(PRESETS)}")
        p = PRESETS[hanabi_name]
        self.game = te.HanabiGame.make(
            colors=p["colors"], ranks=p["ranks"], players=num_agents,
            hand_size=p["hand_size"], max_info=p["max_info"],
            max_life=p["max_life"], minimal=p["minimal"])
        self.device = torch.device(device)
        self.generator = generator
        self.n_envs = n_envs
        self.num_agents = M = num_agents
        self.obs_instead_of_state = use_obs_instead_of_state
        self.obs_dim = self.game.obs_dim + M
        if use_obs_instead_of_state:
            self.share_dim = self.game.obs_dim * M + M
        else:
            self.share_dim = self.game.ownhand_dim + self.game.obs_dim + M
        self.n_moves = self.game.n_moves
        self.observation_space = [sp.Box((self.obs_dim,))] * M
        self.share_observation_space = [sp.Box((self.share_dim,))] * M
        self.action_space = [sp.Discrete(self.n_moves)] * M
        self.states: Optional[te.HanabiState] = None   # protocol API

    # ---- pure API ------------------------------------------------------
    def reset_states(self, decks: Optional[torch.Tensor] = None
                     ) -> te.HanabiState:
        """N fresh games, from `decks` [N, deck_len] or from new shuffles."""
        if decks is None:
            decks = te.shuffled_decks(self.game, self.n_envs, self.generator,
                                      self.device)
        return te.reset_with_deck(self.game, decks.to(self.device))

    def observe(self, states: te.HanabiState):
        """→ (obs [N, Do], share [N, Ds], avail [N, A], cur [N], done [N],
        score [N]); finished games' rows are zeroed."""
        game, M = self.game, self.num_agents
        cur, done = states.cur_player, states.terminal
        enc = te.encode(game, states, cur)
        avail = te.legal_mask_for(game, states, cur)
        turn = torch.nn.functional.one_hot(cur.long(), M).float()
        obs = torch.cat([enc, turn], -1)
        if self.obs_instead_of_state:
            views = [te.encode(game, states, torch.full_like(cur, p))
                     for p in range(M)]
            share = torch.cat(views + [turn], -1)
        else:
            own = te.encode_own_hand(game, states, cur)
            share = torch.cat([own, enc, turn], -1)
        alive = (~done)[:, None].float()
        return (obs * alive, share * alive, avail * alive, cur, done,
                te.score(game, states))

    def pure_step(self, states: te.HanabiState, actions: torch.Tensor):
        """actions [N] (−1 no-op) → (states', obs, share, rewards [N, M, 1],
        done [N], avail [N, A], score [N])."""
        states, rew = te.step(self.game, states, actions)
        obs, share, avail, _, done, scr = self.observe(states)
        rewards = rew[:, None, None].expand(self.n_envs, self.num_agents, 1)
        return states, obs, share, rewards, done, avail, scr

    def masked_reset(self, states: te.HanabiState, mask: torch.Tensor,
                     decks: Optional[torch.Tensor] = None) -> te.HanabiState:
        """Fresh games where `mask` [N], the others untouched; the fresh
        games' decks are drawn, or taken from the rows of `decks`."""
        return self.reset_states(decks).where(mask.to(self.device), states)

    # ---- HanabiVecEnv's numpy protocol --------------------------------
    def reset(self, reset_choose: Optional[np.ndarray] = None):
        if reset_choose is None or self.states is None:
            self.states = self.reset_states()
        else:
            self.states = self.masked_reset(
                self.states, torch.as_tensor(np.asarray(reset_choose, bool)))
        obs, share, avail, cur, _, _ = (x.cpu().numpy()
                                        for x in self.observe(self.states))
        return obs, share, avail, cur

    def step(self, actions: np.ndarray):
        out = self.pure_step(self.states,
                             torch.as_tensor(np.asarray(actions),
                                             device=self.device))
        self.states = out[0]
        obs, share, rewards, done, avail, scr = (x.cpu().numpy()
                                                 for x in out[1:])
        cur = self.states.cur_player.cpu().numpy()
        return obs, share, rewards, done.astype(bool), cur, avail, scr


def upload(device, *arrays):
    """numpy arrays → float32 tensors of the same shapes on `device`, in
    one host-to-device copy: packed end to end, so each is a contiguous
    slice of the copy."""
    flat = [np.asarray(a, np.float32).ravel() for a in arrays]
    packed = torch.from_numpy(np.concatenate(flat)).to(device)
    out, at = [], 0
    for a, f in zip(arrays, flat):
        out.append(packed[at:at + f.size].view(np.shape(a)))
        at += f.size
    return out


class CppHanabiFleet:
    """The pure API of `TorchHanabiFleet` over the C++ engine's numpy
    fleet `env` (a `HanabiVecEnv`), whose protocol `reset` / `step` it
    passes on. The engine holds the one state of its games, so the
    `states` it takes and returns are None. A step copies the actions to
    the host and the engine's outputs back, once each; `masked_reset`
    resets the engine only when some game is chosen."""

    def __init__(self, env, device):
        self.env = env
        self.device = torch.device(device)
        for name in ("n_envs", "num_agents", "obs_dim", "share_dim",
                     "n_moves", "observation_space",
                     "share_observation_space", "action_space"):
            setattr(self, name, getattr(env, name))
        # observe()'s tuple after the last step or reset, and the host's
        # done and score, which a reset does not return
        self._seen = None
        self._done = np.zeros(self.n_envs, bool)
        self._score = np.zeros(self.n_envs, np.int32)

    def _put(self, obs, share, avail, cur, *more):
        obs, share, avail, cur, done, score, *more = upload(
            self.device, obs, share, avail, cur, self._done, self._score,
            *more)
        self._seen = (obs, share, avail, cur.long(), done > 0, score)
        return more

    def _reset(self, mask):
        obs, share, avail, cur = self.env.reset(mask)
        fresh = np.ones(self.n_envs, bool) if mask is None else mask
        self._done = self._done & ~fresh
        self._score = np.where(fresh, 0, self._score)
        self._put(obs, share, avail, cur)

    # ---- pure API ------------------------------------------------------
    def reset_states(self, decks: Optional[torch.Tensor] = None):
        if decks is not None:
            raise ValueError("the C++ engine deals its own decks")
        self._reset(None)

    def observe(self, states):
        """→ (obs, share, avail, cur, done, score) after the last step or
        reset, on the device."""
        return self._seen

    def pure_step(self, states, actions: torch.Tensor):
        obs, share, rewards, self._done, cur, avail, self._score = \
            self.env.step(actions.cpu().numpy().astype(np.int64))
        (rewards,) = self._put(obs, share, avail, cur, rewards)
        obs, share, avail, _, done, score = self._seen
        return None, obs, share, rewards, done, avail, score

    def masked_reset(self, states, mask: torch.Tensor,
                     decks: Optional[torch.Tensor] = None):
        if decks is not None:
            raise ValueError("the C++ engine deals its own decks")
        mask = mask.cpu().numpy()
        if mask.any():
            self._reset(mask)

    # ---- HanabiVecEnv's numpy protocol --------------------------------
    def reset(self, reset_choose: Optional[np.ndarray] = None):
        return self.env.reset(reset_choose)

    def step(self, actions: np.ndarray):
        return self.env.step(actions)

    def close(self):
        self.env.close()
