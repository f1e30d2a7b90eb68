"""Runners for envs that run on the host (SMAC / SMACv2 / GRF / ...).

Port of `onpolicy_tpu/runner/host_runner.py` (the reference's
`runner/shared/smac_runner.py` and `football_runner.py`). External
simulators cannot run on the card, so per step:

    one card call acts for all N·M agents → the actions to the host
    → the env pool steps (`envs/host_vec.py`, worker processes)
    → the step's outputs are staged on the host

and after T steps the staged rollout goes to the card in one copy, where
GAE and the PPO update run as on the device path (the same buffer and
trainers). The pool steps while the card's outputs of the step are
staged (`step_async` / `step_wait`, where the pool has them).

Staging (`_Staging`): the host-side fields of slot t (share_obs, obs,
available actions, masks, then active and bad masks and rewards) lie in
one row of one float32 block [T+1, row], pinned when the device is the
card. Its first four fields, the policy's inputs, go to the card once a
step, as one slice of row t; the whole block goes once an episode. The
policy's outputs (rnn states, actions, log-probs, values) stay on the
card. The actions come back to the host once a step.

Mask semantics are JAX's (`host_runner.py:190-214` there, after the
reference's `smac_runner.py:129-151`): dones_env = all agents done;
masks zeroed on env termination; active_masks zeroed for a dead agent and
set back to 1 on env reset; bad_masks from info["bad_transition"] (per
agent or per env); the recurrent states zeroed where masks are 0.

Randomness: the action draws and minibatch permutations come from one
`torch.Generator` on the run's device, seeded with cfg.seed (JAX splits a
key per step); parameters from a CPU generator with the same seed.
`rollout` takes injected actions (`inject[t]["actions"]` [N, M, heads])
so that a test can hold it in lockstep with the JAX package's.

Resume (`runner/host_resume.py`): the checkpoint holds the train state,
the generators, the episode counter and the staging carry; the env pool
itself cannot be saved (SC2 and GRF are live processes) and is reset.

Data parallelism (`--mesh_shape R` under torchrun; `runner/host_mesh.py`):
each rank owns a pool of `n_rollout_threads` envs, the global batch is
R times that, the episode is gathered rank-major before the returns and
the update, and rank 0 logs and writes the checkpoints (with the global
carry, which every rank restores and cuts to its envs). On a `(data,
model)` mesh (`--mesh_shape D,M`, D·M ranks) each rank keeps its blocks
of the parameters and moments (`parallel/mesh.py`) and acts with its
gathered copy, refreshed once an update: `run_episode` gathers before
the rollout, `run` before an eval (on every rank; the eval env is rank
0's). The checkpoint holds the whole state, written as one process
writes it, and a restore cuts each rank's blocks.

`HostSharedRunner` trains rMAPPO / MAPPO / IPPO (`algorithms/mappo.py`)
and MAT / MAT-dec (`algorithms/mat.py`) through the trainers' rollout-time
interface (`algorithms/__init__.py`); `runner/host_separated_runner.py`
trains per-agent policies (HAPPO, HATRPO, separated MAPPO) over the same
loop.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.algorithms import HAPPO, MAT, make_trainer, trainer_class
from onpolicy_torch.parallel import distributed
from onpolicy_torch.parallel import mesh as mesh_lib
from onpolicy_torch.runner import host_mesh, host_resume
from onpolicy_torch.utils import spaces as sp

_INPUTS = ("share_obs", "obs", "available_actions", "masks")
_OUTCOMES = ("active_masks", "bad_masks", "rewards")


def first_space(space):
    """A list of per-agent spaces (the reference's layout) or one space,
    gym's or the port's → the port's space of the first agent."""
    if isinstance(space, (list, tuple)):
        space = space[0]
    return sp.from_gym(space)


class _Staging:
    """The host-side fields of an episode's T+1 slots in one float32
    block [T+1, row]: each field [T+1, N, M, width] is a view of a column
    range of it, the policy's inputs (`_INPUTS`) first. Pinned when the
    device is the card, and reused from episode to episode: `wait` holds
    the host until the last copy out of it has finished."""

    def __init__(self, T: int, N: int, M: int, widths: dict, device):
        self.device = device
        self.shape = (N, M)
        self.cols, at = {}, 0
        for name in _INPUTS + _OUTCOMES:
            if widths.get(name):
                self.cols[name] = (at, at + N * M * widths[name],
                                   widths[name])
                at = self.cols[name][1]
        self.prefix = max(b for n, (_, b, _) in self.cols.items()
                          if n in _INPUTS)
        pinned = device.type == "cuda"
        self.block = torch.zeros(T + 1, at, pin_memory=pinned)
        rows = self.block.numpy()
        self.host = {n: rows[:, a:b].reshape(T + 1, N, M, w)
                     for n, (a, b, w) in self.cols.items()}
        self._copied = None

    def wait(self):
        if self._copied is not None:
            self._copied.synchronize()
            self._copied = None

    def _views(self, flat, names, lead=()):
        return {n: flat[..., a:b].reshape(*lead, *self.shape, w)
                for n, (a, b, w) in self.cols.items() if n in names}

    def upload_step(self, t: int) -> dict:
        """Slot t's policy inputs on the device, [N, M, width] each: one
        copy."""
        flat = self.block[t, :self.prefix].to(self.device, non_blocking=True,
                                                copy=True)
        return self._views(flat, _INPUTS)

    def upload_all(self) -> dict:
        """Every field on the device, [T+1, N, M, width] each: one copy."""
        flat = self.block.to(self.device, non_blocking=True, copy=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        return self._views(flat, self.cols, (self.block.shape[0],))


class HostRunner:
    """The host loop both host runners share: set-up, the staged rollout,
    deterministic evaluation, checkpoints and `run`. A subclass provides
    `_make_algos(obs_space, share_space)`, `_init_state()`,
    `_act(state, x, rnn_a, rnn_c, given)` (→ values, actions, log-probs,
    rnn states, all [N, M, ...]), `_bootstrap(state, buf)` (→ the values
    [N, M, 1] of the buffer's last slot and the normalizer of GAE),
    `update(state, buf)` and `_eval_act(state, obs, rnn, masks, avail)`."""

    def __init__(self, cfg, vec_env, eval_env=None,
                 env_metrics: Optional[Callable] = None):
        cfg = cfg.validate()
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.init_generator = torch.Generator().manual_seed(cfg.seed)
        self.envs = vec_env
        self.eval_envs = eval_env
        self.num_agents = vec_env.num_agents
        self.N = vec_env.n_envs                    # this rank's envs
        self.mesh = mesh_lib.make_mesh(cfg.mesh_shape, self.device)
        self.draws = self.generator if self.mesh is None else \
            distributed.RowDraws(self.generator, self.mesh)
        self.N_global = self.N * (self.mesh.size if self.mesh else 1)
        self.env_metrics = env_metrics
        self.episodes = (int(cfg.num_env_steps) // cfg.episode_length
                         // self.N_global)
        self.start_episode = 0
        obs_space = first_space(vec_env.observation_space)
        share_space = (first_space(vec_env.share_observation_space)
                       if cfg.use_centralized_V else obs_space)
        self.act_space = first_space(vec_env.action_space)
        self._make_algos(obs_space, share_space)
        self._staging = None
        self._episode = None       # the last rollout's fields, gathered

    def _generators(self) -> dict:
        return {"device": self.generator, "init": self.init_generator}

    def _state(self, state, method):
        """`state` through each trainer's `StateShards.<method>`."""
        algos = getattr(self, "algos", None) or [self.algo]
        return mesh_lib.each_state([a.shards for a in algos], state, method)

    # ------------------------------------------------------------------
    def _observe(self, out, N, M):
        """An env's reset or step output → (obs, share_obs, avail, rest):
        a reset gives (obs, share_obs, avail) or obs alone, a step the
        6-tuple (share protocol) or the 4-tuple, whose centralized state
        is every agent's obs; `rest` is a step's (rewards, dones,
        infos)."""
        share_obs, avail, rest = None, None, None
        if not isinstance(out, tuple):
            obs = out
        elif len(out) == 6:
            obs, share_obs, rewards, dones, infos, avail = out
            rest = (rewards, dones, infos)
        elif len(out) == 4:
            obs, rewards, dones, infos = out
            rest = (rewards, dones, infos)
        else:
            obs, share_obs, avail = out
        obs = np.asarray(obs, np.float32)
        if share_obs is None:
            share_obs = np.tile(obs.reshape(N, 1, -1), (1, M, 1))
        if not self.cfg.use_centralized_V:
            share_obs = obs
        avail = None if avail is None else np.asarray(avail, np.float32)
        return obs, np.asarray(share_obs, np.float32), avail, rest

    def init(self):
        """→ (train state, start carry): the envs reset, the rnn states and
        masks fresh. With cfg.model_dir the state, the carry, the
        generators and the episode counter come from its checkpoint."""
        cfg, N, M = self.cfg, self.N, self.num_agents
        state = self._init_state()
        obs, share_obs, avail, _ = self._observe(self.envs.reset(), N, M)
        zeros = lambda: torch.zeros(N, M, cfg.recurrent_N, cfg.hidden_size,
                                    device=self.device)
        ones = lambda: np.ones((N, M, 1), np.float32)
        start = {"obs": obs, "share_obs": share_obs, "avail": avail,
                 "rnn_a": zeros(), "rnn_c": zeros(), "masks": ones(),
                 "active": ones(), "bad": ones()}
        state, start, self.start_episode = host_resume.restore_run_state(
            cfg, state, start, self.device, self._generators(), self.mesh,
            lambda s: self._state(s, "cut"))
        widths = {"share_obs": share_obs.shape[-1], "obs": obs.shape[-1],
                  "available_actions": 0 if avail is None else avail.shape[-1],
                  "masks": 1, "active_masks": 1, "bad_masks": 1,
                  "rewards": 1}
        self._staging = _Staging(cfg.episode_length, N, M, widths,
                                 self.device)
        return state, start

    def _write(self, t, obs, share_obs, avail, masks, active, bad):
        h = self._staging.host
        h["obs"][t], h["share_obs"][t] = obs, share_obs
        if avail is not None:
            h["available_actions"][t] = avail
        h["masks"][t], h["active_masks"][t], h["bad_masks"][t] = \
            masks, active, bad

    def _bad_masks(self, infos) -> np.ndarray:
        """[N, M, 1]: 0 where an agent's info (or its env's) says
        `bad_transition`."""
        bad = np.ones((self.N, self.num_agents, 1), np.float32)
        for n, info in enumerate(infos):
            if isinstance(info, (list, tuple)):
                for m, im in enumerate(info):
                    if isinstance(im, dict) and im.get("bad_transition"):
                        bad[n, m] = 0.0
            elif isinstance(info, dict) and info.get("bad_transition"):
                bad[n] = 0.0
        return bad

    # ---- one training episode ----------------------------------------
    @torch.no_grad()
    def rollout(self, state, start, inject: Optional[Sequence[dict]] = None):
        """Collect T steps from `start` and compute the returns, acting
        with `state`'s full parameters (gathered on a model axis);
        `inject[t]["actions"]` [N, M, heads] replaces step t's draws.
        → (carry after the last step, buffer with returns, the last
        step's infos)."""
        cfg, N, M = self.cfg, self.N, self.num_agents
        T, dev = cfg.episode_length, self.device
        st = self._staging
        st.wait()
        obs, share_obs, avail = start["obs"], start["share_obs"], start["avail"]
        masks, active, bad = start["masks"], start["active"], start["bad"]
        rnn_a, rnn_c = start["rnn_a"], start["rnn_c"]
        L, H = cfg.recurrent_N, cfg.hidden_size
        heads = sp.action_storage_dim(self.act_space)
        lp = sp.log_prob_dim(self.act_space)
        out = {"rnn_states": torch.empty(T + 1, N, M, L, H, device=dev),
               "rnn_states_critic": torch.empty(T + 1, N, M, L, H, device=dev),
               "actions": torch.empty(T, N, M, heads, device=dev),
               "action_log_probs": torch.empty(T, N, M, lp, device=dev),
               "value_preds": torch.zeros(T + 1, N, M, 1, device=dev)}
        async_pool = hasattr(self.envs, "step_async")
        self._write(0, obs, share_obs, avail, masks, active, bad)
        infos = []
        for t in range(T + 1):
            x = st.upload_step(t)
            # the recurrent states restart where the env terminated
            keep = x["masks"][..., None]
            rnn_a, rnn_c = rnn_a * keep, rnn_c * keep
            out["rnn_states"][t], out["rnn_states_critic"][t] = rnn_a, rnn_c
            if t == T:
                break
            given = inject[t].get("actions") if inject is not None else None
            values, actions, logp, rnn_a, rnn_c = self._act(
                state, x, rnn_a, rnn_c,
                None if given is None else torch.tensor(given, device=dev))
            actions_np = actions.cpu().numpy()
            if async_pool:
                self.envs.step_async(actions_np)
            out["actions"][t], out["action_log_probs"][t] = actions, logp
            out["value_preds"][t] = values
            step = self.envs.step_wait() if async_pool \
                else self.envs.step(actions_np)
            obs, share_obs, avail, (rewards, dones, infos) = self._observe(
                step, N, M)
            dones = np.asarray(dones).reshape(N, M)
            dones_env = dones.all(axis=1)
            masks = np.ones((N, M, 1), np.float32)
            masks[dones_env] = 0.0
            active = np.ones((N, M, 1), np.float32)
            active[dones] = 0.0
            active[dones_env] = 1.0
            bad = self._bad_masks(infos)
            st.host["rewards"][t] = np.asarray(rewards,
                                               np.float32).reshape(N, M, 1)
            self._write(t + 1, obs, share_obs, avail, masks, active, bad)

        # the staged blocks and the policy's outputs of every rank's envs
        traj = distributed.gather_rows({**st.upload_all(), **out}, 1,
                                       self.mesh)
        self._episode = traj
        buf = buf_lib.RolloutBuffer(
            share_obs=traj["share_obs"], obs=traj["obs"],
            rnn_states=traj["rnn_states"],
            rnn_states_critic=traj["rnn_states_critic"],
            actions=traj["actions"],
            action_log_probs=traj["action_log_probs"],
            value_preds=traj["value_preds"], rewards=traj["rewards"][:T],
            masks=traj["masks"], bad_masks=traj["bad_masks"],
            active_masks=traj["active_masks"],
            available_actions=traj.get("available_actions"))
        next_values, norm = self._bootstrap(state, buf)
        buf = buf.compute_returns(
            next_values, norm, gamma=cfg.gamma, gae_lambda=cfg.gae_lambda,
            use_gae=cfg.use_gae,
            use_proper_time_limits=cfg.use_proper_time_limits)
        carry = {"obs": obs, "share_obs": share_obs, "avail": avail,
                 "rnn_a": rnn_a, "rnn_c": rnn_c, "masks": masks,
                 "active": active, "bad": bad}
        return carry, buf, infos

    def _episode_host(self, name: str) -> np.ndarray:
        """A staged field [T, N, M, w] of the last rollout on the host:
        the staging block's, or over a mesh every rank's."""
        T = self.cfg.episode_length
        if self.mesh is None:
            return self._staging.host[name][:T]
        return self._episode[name][:T].cpu().numpy()

    def _episode_metrics(self, metrics, infos) -> dict:
        """The update's metrics as floats, the mean step reward of the
        staged rollout and the env's own (`env_metrics`); over a mesh,
        of every rank's envs."""
        out = {k: float(v) for k, v in metrics.items()}
        out["average_step_rewards"] = float(
            np.mean(self._episode_host("rewards")))
        infos = host_mesh.gather_infos(self.mesh, infos)
        if self.env_metrics is not None:
            out.update(self.env_metrics(infos))
        return out

    def run_episode(self, state, start):
        """Collect T steps and train. → (state, start', metrics)."""
        start, buf, infos = self.rollout(self._state(state, "gathered"),
                                         start)
        state, metrics = self.update(state, buf)
        return state, start, self._episode_metrics(metrics, infos)

    # ---- deterministic evaluation (smac_runner.eval, :161-223) --------
    @torch.no_grad()
    def evaluate(self, state) -> dict:
        """With `state`'s full parameters (gathered on a model axis), each
        head's mode on `eval_envs` (else the training envs) until
        `cfg.eval_episodes` episodes end, or 100,000 steps: the mean episode
        reward and, where the infos carry "won", eval_win_rate."""
        cfg = self.cfg
        env = self.eval_envs or self.envs
        N, M = env.n_envs, self.num_agents
        obs, _, avail, _ = self._observe(env.reset(), N, M)
        rnn = torch.zeros(N, M, cfg.recurrent_N, cfg.hidden_size,
                          device=self.device)
        masks = np.ones((N, M, 1), np.float32)
        wins, ep_rewards, acc = [], [], np.zeros(N)
        on = lambda x: None if x is None else torch.from_numpy(x).to(
            self.device)
        guard = 0
        while len(ep_rewards) < cfg.eval_episodes and guard < 100000:
            guard += 1
            actions, rnn = self._eval_act(state, on(obs), rnn, on(masks),
                                          on(avail))
            obs, _, avail, (rewards, dones, infos) = self._observe(
                env.step(actions.cpu().numpy()), N, M)
            acc += np.asarray(rewards).reshape(N, M).mean(-1)
            done_env = np.asarray(dones).reshape(N, M).all(axis=1)
            masks = np.repeat(1.0 - done_env[:, None, None].astype(np.float32),
                              M, axis=1)
            rnn = rnn * torch.from_numpy(masks[..., None]).to(self.device)
            for n in np.nonzero(done_env)[0]:
                ep_rewards.append(acc[n])
                acc[n] = 0.0
                info = infos[n][0] if isinstance(infos[n], (list, tuple)) \
                    else infos[n]
                if isinstance(info, dict) and "won" in info:
                    wins.append(1.0 if info["won"] else 0.0)
        result = {"eval_average_episode_rewards":
                  float(np.mean(ep_rewards)) if ep_rewards else 0.0}
        if wins:
            result["eval_win_rate"] = float(np.mean(wins))
        return result

    # ---- host training loop ------------------------------------------
    def run(self, log_fn=print, save_dir=None):
        """Train from the start (or cfg.model_dir's checkpoint) to
        num_env_steps: an eval every eval_interval episodes under
        use_eval, a checkpoint every save_interval into `save_dir`, a row
        every log_interval. → (state, rows logged)."""
        cfg = self.cfg
        state, start = self.init()
        steps = cfg.episode_length * self.N_global
        saves = distributed.any_rank(save_dir is not None, self.mesh)
        evals = cfg.use_eval and distributed.any_rank(
            self.eval_envs is not None, self.mesh)
        t0 = time.perf_counter()
        history = []
        for ep in range(self.start_episode, self.episodes):
            state, start, metrics = self.run_episode(state, start)
            if evals and ep % cfg.eval_interval == 0:
                acting = self._state(state, "gathered")
                if self.eval_envs is not None:
                    metrics.update(self.evaluate(acting))
            if saves and (ep % max(cfg.save_interval, 1) == 0
                          or ep == self.episodes - 1):
                host_resume.save_run_state(
                    save_dir, self._state(state, "full"), ep + 1,
                    self._generators(), start, self.mesh)
            if ep % cfg.log_interval == 0 or ep == self.episodes - 1:
                row = {"episode": ep, "steps": (ep + 1) * steps,
                       "fps": (ep + 1 - self.start_episode) * steps
                       / (time.perf_counter() - t0), **metrics}
                history.append(row)
                if log_fn is print:
                    print(f"ep {ep} steps {row['steps']} fps {row['fps']:,.0f}"
                          f" step_rew {row['average_step_rewards']:.3f}")
                elif log_fn is not None:
                    log_fn(row)
        return state, history


class HostSharedRunner(HostRunner):
    """One policy for every agent (rMAPPO, MAPPO, IPPO, MAT, MAT-dec)."""

    def _make_algos(self, obs_space, share_space):
        cfg = self.cfg
        Algo = trainer_class(cfg)
        if issubclass(Algo, HAPPO):
            raise ValueError(f"{Algo.__name__} updates one agent at a time: "
                             "it trains through "
                             "runner/host_separated_runner.py")
        self.algo = make_trainer(cfg, obs_space, share_space, self.act_space,
                                 total_updates=self.episodes,
                                 num_agents=self.num_agents, mesh=self.mesh)
        self.is_mat = isinstance(self.algo, MAT)

    def _init_state(self):
        return self.algo.init_state(self.init_generator, self.device)

    def _act(self, state, x, rnn_a, rnn_c, given):
        return self.algo.get_actions(
            state, x["share_obs"], x["obs"], rnn_a, rnn_c, x["masks"],
            self.draws, x.get("available_actions"), actions=given)

    def _bootstrap(self, state, buf):
        values, _ = self.algo.get_values(
            state, buf.share_obs[-1], buf.rnn_states_critic[-1],
            buf.masks[-1], buf.obs[-1])
        return values, state.vnorm

    def update(self, state, buf):
        return self.algo.train(state, buf, self.generator)

    def _episode_metrics(self, metrics, infos) -> dict:
        out = super()._episode_metrics(metrics, infos)
        out["dead_ratio"] = 1.0 - float(
            np.mean(self._episode_host("active_masks")))
        return out

    def _eval_act(self, state, obs, rnn, masks, avail):
        actions, _, rnn = self.algo.act(state, obs, rnn, masks,
                                        available_actions=avail,
                                        deterministic=True)
        return actions, rnn
