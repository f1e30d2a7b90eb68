"""Device-resident Hanabi fleet: N lockstep games as one batched state.

Port of `onpolicy_tpu/envs/hanabi/jax_fleet.py`, with the observation
composition of `HanabiVecEnv` (the reference's `Hanabi_Env.py:305-311`):
obs = canonical(cur) + agent-turn one-hot; share = own-hand(cur) +
canonical(cur) + turn, or all players' views + turn under
`use_obs_instead_of_state`; finished games present zeroed rows and zero
availability; action −1 = no-op; reward = score delta broadcast to the
players.

Two APIs over the engine (`torch_engine.py`):
  * pure: `reset_states` / `observe` / `pure_step` / `masked_reset` /
    `reset_observe` (the masked reset, then `observe`) on device tensors,
    which the runner's episode loop composes with no host transfer;
  * protocol: numpy `reset(mask)` / `step(actions)`, as HanabiVecEnv's.
Decks are shuffled on the fleet's device from its generator;
`reset_states`, `masked_reset` and `reset_observe` also take decks
[N, deck_len], so that a test can hand two implementations the same deals.

On a CUDA device the step chain (`te.step`, `observe`) and the reset
chain (the decks' draw, `reset_with_deck`, the masked `where`, `observe`)
are each captured once as a CUDA graph (`_Graphs`) and replayed: one
launch in place of the ≈ 700 and ≈ 400 small kernels a host would
dispatch, with the same operations on the same inputs, so the same bits.
The graphs read and write the fleet's resident state in place: the state
`pure_step`, `masked_reset` and `reset_observe` return there is the
fleet's own, valid until its next step or reset (pass it back, or clone
it to keep it); a state returned before that raises. On the CPU the
chains run op by op.

`CppHanabiFleet` gives the C++ engine's fleet (`hanabi_env.HanabiVecEnv`)
the same two APIs, so that the runner's device round drives either engine.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from onpolicy_torch.envs.hanabi import torch_engine as te
from onpolicy_torch.envs.hanabi.hanabi_env import PRESETS
from onpolicy_torch.utils import profiling
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
        self._graphs: Optional[_Graphs] = None   # CUDA: made at first use

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
        graphs = self._graphs_for(states)
        states, obs, share, avail, rew, done, scr = (
            self._step_chain(states, actions) if graphs is None
            else graphs.step(states, actions))
        rewards = rew[:, None, None].expand(self.n_envs, self.num_agents, 1)
        return states, obs, share, rewards, done, avail, scr

    def masked_reset(self, states: te.HanabiState, mask: torch.Tensor,
                     decks: Optional[torch.Tensor] = None) -> te.HanabiState:
        """Fresh games where `mask` [N], the others untouched; the fresh
        games' decks are drawn, or taken from the rows of `decks`."""
        return self.reset_observe(states, mask, decks)[0]

    def reset_observe(self, states: te.HanabiState, mask: torch.Tensor,
                      decks: Optional[torch.Tensor] = None):
        """`masked_reset`, then `observe` → (states', obs, share, avail,
        cur, done, score). The fleet draws N decks whichever games reset."""
        graphs = None if decks is not None else self._graphs_for(states)
        if graphs is None:
            return self._reset_chain(states, mask.to(self.device), decks)
        return graphs.reset(states, mask)

    # the two chains, run op by op or captured
    def _step_chain(self, states, actions):
        states, rew = te.step(self.game, states, actions)
        obs, share, avail, _, done, scr = self.observe(states)
        return states, obs, share, avail, rew, done, scr

    def _reset_chain(self, states, mask, decks=None):
        states = self.reset_states(decks).where(mask, states)
        return (states, *self.observe(states))

    def _graphs_for(self, states) -> Optional["_Graphs"]:
        """The fleet's CUDA graphs, captured from `states` at the first
        call; None on the CPU."""
        if self.device.type != "cuda":
            return None
        if self._graphs is None:
            self._graphs = _Graphs(self, states)
        return self._graphs

    # ---- HanabiVecEnv's numpy protocol --------------------------------
    def reset(self, reset_choose: Optional[np.ndarray] = None):
        if reset_choose is None or self.states is None:
            self.states = self.reset_states()
            seen = self.observe(self.states)
        else:
            self.states, *seen = self.reset_observe(
                self.states, torch.as_tensor(np.asarray(reset_choose, bool)))
        obs, share, avail, cur, _, _ = (x.cpu().numpy() for x in seen)
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


class _Graphs:
    """A CUDA fleet's step and reset chains as two CUDA graphs over
    resident buffers: the state (a copy of the first state given), the
    actions [N] and the reset mask [N]. Each graph runs its chain on the
    resident state, then copies the new state over it; its other outputs
    are cloned after each replay, so that a caller may keep them.

    The reset graph draws its decks from the fleet's generator, which is
    registered with it: each replay takes the Philox offsets the eager
    draw would take at that point, so eager draws on the same generator
    (the actor's) interleave unchanged. Warm-up and capture leave the
    generator's state as they found it."""

    def __init__(self, fleet: TorchHanabiFleet, states: te.HanabiState):
        dev, n = fleet.device, fleet.n_envs
        self.state = te.HanabiState(**{k: v.clone() for k, v
                                       in states.tensors().items()})
        self.actions = torch.full((n,), -1, dtype=torch.long, device=dev)
        self.mask = torch.zeros(n, dtype=torch.bool, device=dev)
        self.live = None          # the state last returned
        gen = fleet.generator
        saved = gen.get_state()
        # warm-up (the engine's tables, the kernels' first use) on a side
        # stream, as capture wants
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fleet._step_chain(self.state, self.actions)
            fleet._reset_chain(self.state, self.mask)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.step_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.step_graph):
            new, *self.step_out = fleet._step_chain(self.state, self.actions)
            self._keep(new)
        self.reset_graph = torch.cuda.CUDAGraph()
        self.reset_graph.register_generator_state(gen)
        with torch.cuda.graph(self.reset_graph):
            new, *self.reset_out = fleet._reset_chain(self.state, self.mask)
            self._keep(new)
        gen.set_state(saved)

    def _keep(self, new: te.HanabiState):
        for k, v in new.tensors().items():
            getattr(self.state, k).copy_(v)

    def _load(self, states: te.HanabiState):
        """The caller's state into the resident one, unless it is it."""
        if states is self.live:
            return
        if states.deck is self.state.deck:
            raise ValueError(
                "a state the fleet returned before its last step or reset: "
                "the CUDA graphs have overwritten it (clone a state to keep "
                "it)")
        self._keep(states)

    def _replay(self, graph, outs):
        graph.replay()
        profiling.count("env_graph_replays")
        self.live = te.HanabiState(**self.state.tensors())
        return (self.live, *(x.clone() for x in outs))

    def step(self, states, actions):
        self._load(states)
        self.actions.copy_(actions)
        return self._replay(self.step_graph, self.step_out)

    def reset(self, states, mask):
        self._load(states)
        self.mask.copy_(mask)
        return self._replay(self.reset_graph, self.reset_out)


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

    def reset_observe(self, states, mask: torch.Tensor,
                      decks: Optional[torch.Tensor] = None):
        self.masked_reset(states, mask, decks)
        return (None, *self._seen)

    # ---- HanabiVecEnv's numpy protocol --------------------------------
    def reset(self, reset_choose: Optional[np.ndarray] = None):
        return self.env.reset(reset_choose)

    def step(self, actions: np.ndarray):
        return self.env.step(actions)

    def close(self):
        self.env.close()
