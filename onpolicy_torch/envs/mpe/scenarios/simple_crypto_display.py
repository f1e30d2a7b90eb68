"""simple_crypto_display: the display variant of simple_crypto.

Port of `onpolicy_tpu/envs/mpe/scenarios/simple_crypto_display.py`: the
same 3-agent comm game (Eve, Bob, Alice; dim_c=4; random goal and key;
the rewards and observations of simple_crypto), reset to a FIXED layout:
agents on the line x=0 at y = −0.5 + i/(M−1), landmarks on x=0.5 at
y = 0.5 − 0.5·i/(K−1). The reference's debug prints and colours do not
touch the state.
"""
from __future__ import annotations

import torch

from onpolicy_torch.envs.mpe import scenario as sc
from onpolicy_torch.envs.mpe.scenarios import simple_crypto as _crypto

shared_reward = _crypto.shared_reward
DIM_C = _crypto.DIM_C

make_spec = _crypto.make_spec
observation = _crypto.observation
reward = _crypto.reward


def reset(spec, n_envs: int, generator, device, dtype):
    M, K = spec.n_agents, spec.n_landmarks
    line = lambda n, x, y0, dy: torch.stack([
        torch.full((n,), x, dtype=dtype, device=device),
        y0 + dy * torch.arange(n, dtype=dtype, device=device) / max(n - 1, 1)],
        -1).expand(n_envs, n, 2)
    return sc.base_state(
        spec, line(M, 0.0, -0.5, 1.0).clone(), line(K, 0.5, 0.5, -0.5).clone(),
        extras=_crypto.goal_and_key(spec, n_envs, generator, device))
