"""Env-side wrappers for host envs.

The port's own copy of `onpolicy_tpu/envs/wrappers.py`
(the port imports nothing from the JAX package); held to it by
tests/test_torch_host_vec.py.

StackedFrames: parity with the reference's stacked-frames option
(`--use_stacked_frames --stacked_frames K`, consumed by SMAC's env in
`StarCraft2_Env.py:325-327,427-435,605-613`).
"""
from __future__ import annotations

import numpy as np

from onpolicy_torch.utils import spaces as sp


class StackedFrames:
    """Wrap a share-protocol env; obs/share_obs become K-frame stacks
    with the REFERENCE's exact update semantics:

      * buffers are zero-initialized ONCE at construction
        (`StarCraft2_Env.py:325-327`) and NEVER cleared — frames leak
        across episode boundaries exactly as the reference's do (a
        preserved quirk);
      * every reset() and step() does `np.roll(buf, 1, axis=1)` then
        writes the newest frame at `[:, -1]` (`:427-435`, `:605-613`),
        so the flattened layout is
        `[f_{t-1} | f_{t-2} | ... | f_{t-K+1} | f_t]` — newest last,
        the rest reverse-chronological before it (NOT an ordered
        window);
      * outputs are `buf.reshape(n_agents, -1)`.

    Pinned against the reference's own executed update block in
    tests/test_smac_reference_golden.py.
    """

    def __init__(self, env, k: int):
        self.env = env
        self.k = k
        self.num_agents = env.num_agents
        self.action_space = env.action_space

        def dim(s):
            s0 = s[0] if isinstance(s, (list, tuple)) else s
            return s0.shape[0]

        self._obs_dim = dim(env.observation_space)
        self._share_dim = dim(env.share_observation_space)
        self.observation_space = [sp.Box((self._obs_dim * k,))] \
            * self.num_agents
        self.share_observation_space = [sp.Box((self._share_dim * k,))] \
            * self.num_agents
        M = self.num_agents
        self._obs_buf = np.zeros((M, k, self._obs_dim), np.float32)
        self._share_buf = np.zeros((M, k, self._share_dim), np.float32)

    def _push(self, obs, share):
        self._obs_buf = np.roll(self._obs_buf, 1, axis=1)
        self._share_buf = np.roll(self._share_buf, 1, axis=1)
        self._obs_buf[:, -1, :] = np.asarray(obs, np.float32)
        self._share_buf[:, -1, :] = np.asarray(share, np.float32)
        return (self._obs_buf.reshape(self.num_agents, -1).copy(),
                self._share_buf.reshape(self.num_agents, -1).copy())

    def reset(self):
        obs, share, avail = self.env.reset()
        o, s = self._push(obs, share)
        return o, s, avail

    def step(self, actions):
        obs, share, rew, dones, infos, avail = self.env.step(actions)
        o, s = self._push(obs, share)
        return o, s, rew, dones, infos, avail

    def close(self):
        self.env.close()
