"""Hanabi game presets.

The port's own copy of the preset table of
`onpolicy_tpu/envs/hanabi/hanabi_env.py` (the reference's
`Hanabi_Env.py:118-160`). `HanabiVecEnv`, the fleet over the C++ engine,
comes with ROADMAP.md item E2; the port's device-resident fleet is
`torch_fleet.TorchHanabiFleet`.
"""
from __future__ import annotations

PRESETS = {
    "Hanabi-Full": dict(colors=5, ranks=5, max_info=8, max_life=3,
                        hand_size=-1, minimal=False),
    # MINIMAL observation_type: no V0-belief section (Hanabi_Env.py:136)
    "Hanabi-Full-Minimal": dict(colors=5, ranks=5, max_info=8, max_life=3,
                                hand_size=-1, minimal=True),
    "Hanabi-Small": dict(colors=2, ranks=5, max_info=3, max_life=1,
                         hand_size=2, minimal=False),
    "Hanabi-Very-Small": dict(colors=1, ranks=5, max_info=3, max_life=1,
                              hand_size=2, minimal=False),
}
