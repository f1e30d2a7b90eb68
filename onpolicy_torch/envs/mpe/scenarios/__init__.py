"""Scenario registry. simple_spread, simple_reference and
simple_speaker_listener are ported; the other scenarios of the JAX
package's registry are named so that asking for one says where its port
stands."""
from __future__ import annotations

import importlib

_SCENARIOS = {
    "simple_spread": "onpolicy_torch.envs.mpe.scenarios.simple_spread",
    "simple_reference": "onpolicy_torch.envs.mpe.scenarios.simple_reference",
    "simple_speaker_listener":
        "onpolicy_torch.envs.mpe.scenarios.simple_speaker_listener",
}
_NOT_PORTED = (
    "simple_adversary", "simple_tag", "simple_push", "simple_attack",
    "simple_crypto", "simple_crypto_display", "simple_world_comm",
)


def load(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"MPE scenario {name!r} is not ported yet (ROADMAP.md, item B3)")
    if name not in _SCENARIOS:
        raise ValueError(
            f"unknown MPE scenario {name!r}; available: {sorted(_SCENARIOS)}")
    return importlib.import_module(_SCENARIOS[name])
