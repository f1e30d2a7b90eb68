"""Scenario registry: every scenario of the JAX package's registry, by
name (an explicit module map, as the JAX package keeps)."""
from __future__ import annotations

import importlib

_SCENARIOS = {name: f"onpolicy_torch.envs.mpe.scenarios.{name}" for name in (
    "simple_spread", "simple_reference", "simple_speaker_listener",
    "simple_adversary", "simple_tag", "simple_push", "simple_attack",
    "simple_crypto", "simple_crypto_display", "simple_world_comm")}


def load(name: str):
    if name not in _SCENARIOS:
        raise ValueError(
            f"unknown MPE scenario {name!r}; available: {sorted(_SCENARIOS)}")
    return importlib.import_module(_SCENARIOS[name])


def available():
    return sorted(_SCENARIOS)
