"""The trainers, and the one table that picks one by `algorithm_name`.

Every trainer has the same rollout-time interface, which is all a runner
calls between updates:

    get_actions(state, share_obs, obs, rnn_actor, rnn_critic, masks,
                generator, available_actions=None, deterministic=False,
                actions=None) → (values, actions, log_probs, rnn_actor,
                                 rnn_critic)
    get_values(state, share_obs, rnn_critic, masks, obs=None)
        → (values, rnn_critic)
    act(state, obs, rnn_actor, masks, generator=None,
        available_actions=None, deterministic=True, share_obs=None)
        → (actions, log_probs, rnn_actor)

Rows come flat [B, ...] or by env [N, M, ...] (an env's M agents
consecutive), and the outputs keep the leading shape of the inputs. A
trainer ignores the inputs it does not read. HAPPO and HATRPO update one
agent at a time and train through the separated runners; the shared
runners refuse them.
"""
from __future__ import annotations

from onpolicy_torch.algorithms.happo import HAPPO
from onpolicy_torch.algorithms.hatrpo import HATRPO
from onpolicy_torch.algorithms.mappo import MAPPO
from onpolicy_torch.algorithms.mat import MAT

TRAINERS = {"mappo": MAPPO, "rmappo": MAPPO, "ippo": MAPPO,
            "happo": HAPPO, "hatrpo": HATRPO, "mat": MAT, "mat_dec": MAT}


def trainer_class(cfg):
    """The trainer class of `cfg.algorithm_name` (checked by
    `config.canonicalize_algorithm`)."""
    return TRAINERS[cfg.algorithm_name]


def make_trainer(cfg, obs_space, share_obs_space, act_space,
                 total_updates: int = 1, num_agents: int = None, mesh=None):
    """The trainer of `cfg.algorithm_name` over these spaces; `num_agents`
    is the agents of one env in its rows (default cfg.num_agents)."""
    return trainer_class(cfg)(cfg, obs_space, share_obs_space, act_space,
                              total_updates=total_updates,
                              num_agents=num_agents, mesh=mesh)
