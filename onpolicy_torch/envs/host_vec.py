"""Host-side vectorized env pool for external engines (SMAC/Hanabi/GRF).

The port's own copy of `onpolicy_tpu/envs/host_vec.py` (the port imports
nothing from the JAX package); held to it by tests/test_torch_host_vec.py.

Replaces the reference's `SubprocVecEnv` family
(the reference's `onpolicy/envs/env_wrappers.py:140-822`) — which
scatters actions and gathers observations through per-env pickle pipes —
with a batched ingestion path: one worker process per env,
a SHARED-MEMORY data plane (workers write obs/state/reward/mask slices
directly into preallocated numpy blocks; the trainer reads whole stacked
arrays with zero copies), and pipes only for control messages and info
dicts. `step_async`/`step_wait` let env stepping overlap with device
work (double buffering).

The workers run numpy and the env only: this module imports neither
torch nor anything that does, so a worker forked from a process that
holds a CUDA context never touches it. Workers fork by default (`context`
names another start method; the env functions must then be picklable).

Protocols (matching the reference wrapper families):
  * "basic"  — step → (obs, rewards, dones, infos); auto-reset
               (`SubprocVecEnv`, worker:140-174)
  * "share"  — adds share_obs + available_actions 6-tuple; auto-reset
               (`ShareSubprocVecEnv`, shareworker:300-338)
  * "choose" — 6-tuple, NO auto-reset, masked `reset(reset_choose)`
               (`ChooseSubprocVecEnv`, chooseworker:493-575; turn-based
               Hanabi)

Env contract ("share"/"choose"): reset() → (obs, share_obs,
available_actions); step(a) → (obs, share_obs, rewards, dones, infos,
available_actions). "basic": reset() → obs;
step(a) → (obs, rewards, dones, infos). Arrays are per-agent stacked
[M, ...] like the reference envs.
"""
from __future__ import annotations

import multiprocessing as mp
from multiprocessing import shared_memory
from typing import Callable, List, Optional, Sequence

import numpy as np

_FIELDS = ("obs", "share_obs", "rewards", "dones", "avail", "actions",
           "reset_choose")


class _ShmBlock:
    """A named shared-memory numpy array."""

    def __init__(self, name, shape, dtype, create):
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        self.shm = shared_memory.SharedMemory(
            name=name, create=create, size=max(nbytes, 1))
        self.array = np.ndarray(shape, dtype, buffer=self.shm.buf)

    def close(self, unlink=False):
        self.shm.close()
        if unlink:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass


def _probe_env(env_fn, protocol):
    env = env_fn()
    try:
        if protocol in ("share", "choose"):
            out = env.reset()
            obs, share_obs, avail = out
            obs = np.asarray(obs, np.float32)
            share_obs = np.asarray(share_obs, np.float32)
            avail = None if avail is None else np.asarray(avail, np.float32)
        else:
            obs = np.asarray(env.reset(), np.float32)
            share_obs, avail = None, None
        num_agents = getattr(env, "num_agents", obs.shape[0])
        spaces = (env.observation_space, env.share_observation_space
                  if hasattr(env, "share_observation_space") else None,
                  env.action_space)
        return obs, share_obs, avail, num_agents, spaces
    finally:
        env.close()


def _worker(remote, env_fn, protocol, idx, shm_specs):
    blocks = {k: _ShmBlock(name, shape, dtype, create=False)
              for k, (name, shape, dtype) in shm_specs.items()}
    env = env_fn()
    auto_reset = protocol in ("basic", "share")

    def write_obs(out):
        if protocol in ("share", "choose"):
            obs, share_obs, avail = out
            blocks["obs"].array[idx] = obs
            blocks["share_obs"].array[idx] = share_obs
            if "avail" in blocks:
                blocks["avail"].array[idx] = avail
        else:
            blocks["obs"].array[idx] = out

    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "step":
                action = blocks["actions"].array[idx]
                out = env.step(action)
                if protocol in ("share", "choose"):
                    obs, share_obs, rewards, dones, infos, avail = out
                else:
                    obs, rewards, dones, infos = out
                    share_obs, avail = None, None
                done_all = np.all(dones) if np.ndim(dones) else bool(dones)
                if auto_reset and done_all:
                    reset_out = env.reset()
                    if protocol in ("share", "choose"):
                        obs, share_obs, avail = reset_out
                    else:
                        obs = reset_out
                blocks["obs"].array[idx] = obs
                if share_obs is not None:
                    blocks["share_obs"].array[idx] = share_obs
                if avail is not None and "avail" in blocks:
                    blocks["avail"].array[idx] = avail
                blocks["rewards"].array[idx] = np.asarray(
                    rewards, np.float32).reshape(
                        blocks["rewards"].array[idx].shape)
                blocks["dones"].array[idx] = np.asarray(dones).reshape(
                    blocks["dones"].array[idx].shape)
                remote.send(infos)
            elif cmd == "reset":
                if protocol != "choose" or blocks["reset_choose"].array[idx]:
                    write_obs(env.reset())
                remote.send(True)
            elif cmd == "render":
                remote.send(env.render(data) if data else env.render())
            elif cmd == "close":
                remote.send(True)
                break
            else:
                raise RuntimeError(f"unknown command {cmd!r}")
    finally:
        env.close()
        for b in blocks.values():
            b.close()


class HostVecEnv:
    def __init__(self, env_fns: Sequence[Callable], protocol: str = "share",
                 context: str = "fork"):
        assert protocol in ("basic", "share", "choose")
        self.protocol = protocol
        self.n_envs = N = len(env_fns)
        obs, share_obs, avail, M, spaces = _probe_env(env_fns[0], protocol)
        self.num_agents = M
        self.observation_space, self.share_observation_space, \
            self.action_space = spaces

        import uuid
        tag = uuid.uuid4().hex[:8]
        act_dim = self._action_width(self.action_space)
        specs = {
            "obs": (f"opt_obs_{tag}", (N,) + obs.shape, np.float32),
            "rewards": (f"opt_rew_{tag}", (N, M, 1), np.float32),
            "dones": (f"opt_done_{tag}", (N, M), np.bool_),
            "actions": (f"opt_act_{tag}", (N, M, act_dim), np.float32),
        }
        if share_obs is not None:
            specs["share_obs"] = (f"opt_sobs_{tag}",
                                  (N,) + share_obs.shape, np.float32)
        if avail is not None:
            specs["avail"] = (f"opt_av_{tag}", (N,) + avail.shape, np.float32)
        if protocol == "choose":
            specs["reset_choose"] = (f"opt_rc_{tag}", (N,), np.bool_)
        self._blocks = {k: _ShmBlock(*v, create=True)
                        for k, v in specs.items()}
        self._specs = specs

        ctx = mp.get_context(context)
        self._remotes, self._procs = [], []
        for i, fn in enumerate(env_fns):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_worker,
                            args=(child, fn, protocol, i, specs),
                            daemon=True)
            p.start()
            child.close()
            self._remotes.append(parent)
            self._procs.append(p)
        self._waiting = False
        self._closed = False

    @staticmethod
    def _action_width(action_space) -> int:
        from onpolicy_torch.utils import spaces as sp
        try:
            first = action_space[0]
        except TypeError:
            first = action_space
        try:
            return max(1, sp.action_storage_dim(first))
        except TypeError:
            return int(np.asarray(first.sample()).size)  # gym space

    # ---- stepping -----------------------------------------------------
    def step_async(self, actions: np.ndarray):
        assert not self._waiting
        acts = np.asarray(actions, np.float32).reshape(
            self._blocks["actions"].array.shape)
        self._blocks["actions"].array[:] = acts
        for r in self._remotes:
            r.send(("step", None))
        self._waiting = True

    def step_wait(self):
        assert self._waiting
        infos = [r.recv() for r in self._remotes]
        self._waiting = False
        b = self._blocks
        if self.protocol in ("share", "choose"):
            return (b["obs"].array.copy(), b["share_obs"].array.copy(),
                    b["rewards"].array.copy(), b["dones"].array.copy(),
                    infos,
                    b["avail"].array.copy() if "avail" in b else None)
        return (b["obs"].array.copy(), b["rewards"].array.copy(),
                b["dones"].array.copy(), infos)

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def reset(self, reset_choose: Optional[np.ndarray] = None):
        if self.protocol == "choose":
            mask = np.ones(self.n_envs, bool) if reset_choose is None \
                else np.asarray(reset_choose, bool)
            self._blocks["reset_choose"].array[:] = mask
        for r in self._remotes:
            r.send(("reset", None))
        for r in self._remotes:
            r.recv()
        b = self._blocks
        if self.protocol in ("share", "choose"):
            return (b["obs"].array.copy(), b["share_obs"].array.copy(),
                    b["avail"].array.copy() if "avail" in b else None)
        return b["obs"].array.copy()

    def render(self, mode="rgb_array"):
        """Env 0's frame (JAX's `HostVecEnv.render`)."""
        self._remotes[0].send(("render", mode))
        return self._remotes[0].recv()

    def close(self):
        if self._closed:
            return
        self._closed = True
        for r in self._remotes:
            try:
                r.send(("close", None))
                r.recv()
            except (BrokenPipeError, EOFError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        for blk in self._blocks.values():
            blk.close(unlink=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DummyVecEnv:
    """In-process serial pool (the reference's DummyVecEnv family,
    env_wrappers.py:661-822) — for n_rollout_threads == 1 or debugging."""

    def __init__(self, env_fns: Sequence[Callable], protocol: str = "share"):
        assert protocol in ("basic", "share", "choose")
        self.protocol = protocol
        self.envs = [fn() for fn in env_fns]
        self.n_envs = len(self.envs)
        env = self.envs[0]
        self.num_agents = getattr(env, "num_agents", None)
        self.observation_space = env.observation_space
        self.share_observation_space = getattr(env, "share_observation_space",
                                               None)
        self.action_space = env.action_space

    def reset(self, reset_choose=None):
        shared = self.protocol in ("share", "choose")
        outs = []
        for i, env in enumerate(self.envs):
            if self.protocol == "choose" and reset_choose is not None \
                    and not reset_choose[i]:
                outs.append(None)
            else:
                outs.append(env.reset())
        if shared:
            prev = getattr(self, "_last", None)
            obs, sobs, avail = [], [], []
            for i, o in enumerate(outs):
                if o is None:
                    obs.append(prev[0][i])
                    sobs.append(prev[1][i])
                    avail.append(prev[2][i] if prev[2] is not None else None)
                else:
                    obs.append(o[0]); sobs.append(o[1]); avail.append(o[2])
            obs = np.stack(obs); sobs = np.stack(sobs)
            avail = None if avail[0] is None else np.stack(avail)
            self._last = (obs, sobs, avail)
            return obs, sobs, avail
        obs = np.stack(outs)
        self._last = obs
        return obs

    def step(self, actions):
        shared = self.protocol in ("share", "choose")
        rows = []
        for env, a in zip(self.envs, actions):
            out = env.step(a)
            if shared:
                obs, sobs, rew, done, info, avail = out
                if self.protocol == "share" and np.all(done):
                    obs, sobs, avail = env.reset()
                rows.append((obs, sobs, rew, done, info, avail))
            else:
                obs, rew, done, info = out
                if np.all(done) if np.ndim(done) else done:
                    obs = env.reset()
                rows.append((obs, rew, done, info))
        cols = list(zip(*rows))
        if shared:
            obs, sobs, rew, done, infos, avail = cols
            self._last = (np.stack(obs), np.stack(sobs),
                          None if avail[0] is None else np.stack(avail))
            return (np.stack(obs), np.stack(sobs),
                    np.asarray(rew, np.float32).reshape(self.n_envs, -1, 1),
                    np.asarray(done), list(infos),
                    None if avail[0] is None else np.stack(avail))
        obs, rew, done, infos = cols
        self._last = np.stack(obs)
        return (np.stack(obs),
                np.asarray(rew, np.float32).reshape(self.n_envs, -1, 1),
                np.asarray(done), list(infos))

    def close(self):
        for env in self.envs:
            env.close()
