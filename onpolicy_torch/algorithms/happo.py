"""HAPPO: Heterogeneous-Agent PPO trainer.

Port of `onpolicy_tpu/algorithms/happo.py` (the reference's
`happo_trainer.py`): the MAPPO trainer with the importance ratio taken
jointly over action heads, exp(Σ_k Δlogp_k) keepdim, and the clipped
surrogate weighted by the running `factor` of the sequential agent-by-agent
update, which the separated runner keeps (`runner/separated_runner.py`).
Under `use_popart` it keeps the stats-only normalizer and leaves the
critic's head as it is (`popart_rescales_head = False`; the reference's
popart_hatrpo.py is a ValueNorm clone).
"""
from __future__ import annotations

from onpolicy_torch.algorithms.mappo import MAPPO


class HAPPO(MAPPO):
    prod_ratio_heads = True
    popart_rescales_head = False
