"""The trainers' one rollout-time interface (`onpolicy_torch/algorithms`),
on the CPU, for every algorithm name:

  * the table picks the expected trainer, and `get_actions`,
    `get_values` and `act` have one parameter list on MAPPO and MAT;
  * on a small MPE batch (N=4 envs, M=3 agents), `get_actions` equals
    calling the trainer's networks directly (the actor, then the critic;
    for MAT one `transformer.autoregressive_act`), rows by env
    [N, M, ...] or flat [N·M, ...] alike;
  * `act` with each head's mode gives what `get_actions` gives with it;
  * under `use_critic_dedup` MAPPO's `get_values` on the agent-invariant
    [N, M, M·D] view equals the per-row critic on the copied rows.
"""
import inspect

import pytest
import torch

from onpolicy_torch.algorithms import (HAPPO, HATRPO, MAPPO, MAT, TRAINERS,
                                       make_trainer, trainer_class)
from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.models import transformer as tfm
from onpolicy_torch.utils import spaces as sp

N, M, D = 4, 3, 18        # simple_spread: 3 agents, 18-wide obs
NAMES = ["mappo", "rmappo", "ippo", "happo", "hatrpo", "mat", "mat_dec"]
EXPECTED = {"mappo": MAPPO, "rmappo": MAPPO, "ippo": MAPPO, "happo": HAPPO,
            "hatrpo": HATRPO, "mat": MAT, "mat_dec": MAT}


def _setup(name, **over):
    cfg = canonicalize_algorithm(Config(
        algorithm_name=name, device="cpu", num_agents=M, hidden_size=16,
        n_embd=16, **over))
    share = sp.Box((M * D,)) if cfg.use_centralized_V else sp.Box((D,))
    algo = make_trainer(cfg, sp.Box((D,)), share, sp.Discrete(5),
                        num_agents=M)
    state = algo.init_state(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    obs = torch.randn(N, M, D, generator=g)
    share_obs = (obs.reshape(N, 1, M * D).expand(N, M, M * D)
                 if cfg.use_centralized_V else obs)
    rnn = lambda: torch.randn(N, M, cfg.recurrent_N, cfg.hidden_size,
                              generator=g)
    masks = torch.ones(N, M, 1)
    masks[1, :] = 0.0        # an env that just reset
    return cfg, algo, state, (share_obs, obs, rnn(), rnn(), masks)


def _flat(x):
    return x.reshape(N * M, *x.shape[2:])


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_table_and_one_parameter_list(name):
    cfg = canonicalize_algorithm(Config(algorithm_name=name))
    assert TRAINERS[name] is EXPECTED[name] is trainer_class(cfg)
    params = lambda f: [(p.name, p.kind, p.default)
                        for p in inspect.signature(f).parameters.values()]
    for method in ("get_actions", "get_values", "act"):
        assert params(getattr(trainer_class(cfg), method)) \
            == params(getattr(MAPPO, method)) == params(getattr(MAT, method))


@pytest.mark.parametrize("name", NAMES)
def test_get_actions_is_the_networks(name):
    cfg, algo, state, (share_obs, obs, rnn_a, rnn_c, masks) = _setup(name)
    draws = lambda: torch.Generator().manual_seed(7)
    got = algo.get_actions(state, share_obs, obs, rnn_a, rnn_c, masks,
                           draws())
    if isinstance(algo, MAT):
        acts, logp, values = tfm.autoregressive_act(
            algo.mcfg, state.params, obs, draws(), None, False)
        want = (values, acts, logp, rnn_a, rnn_c)
    else:
        acts, logp, ra = algo.actor.forward(
            state.actor_params, _flat(obs), _flat(rnn_a), _flat(masks),
            draws())
        values, rc = algo.critic.forward(state.critic_params,
                                         _flat(share_obs), _flat(rnn_c),
                                         _flat(masks))
        want = tuple(x.reshape(N, M, *x.shape[1:])
                     for x in (values, acts, logp, ra, rc))
    _assert_same(got, want)
    # flat rows give the same rows
    flat = algo.get_actions(state, *map(_flat, (share_obs, obs, rnn_a,
                                                rnn_c, masks)), draws())
    _assert_same(flat, tuple(map(_flat, got)))
    values, rc = algo.get_values(state, share_obs, rnn_c, masks, obs)
    _assert_same((values, rc), (got[0], got[4]))


@pytest.mark.parametrize("name", NAMES)
def test_act_is_get_actions_deterministic(name):
    cfg, algo, state, (share_obs, obs, rnn_a, rnn_c, masks) = _setup(name)
    values, actions, logp, ra, _ = algo.get_actions(
        state, share_obs, obs, rnn_a, rnn_c, masks, None,
        deterministic=True)
    _assert_same(algo.act(state, obs, rnn_a, masks, share_obs=share_obs),
                 (actions, logp, ra))


@pytest.mark.parametrize("layout", ["by_env", "flat"])
def test_dedup_values_are_the_per_row_critic(layout):
    cfg, algo, state, (share_obs, _, _, rnn_c, masks) = _setup(
        "mappo", use_critic_dedup=True)
    assert cfg.validate().use_critic_dedup
    want, _ = algo.critic.forward(state.critic_params, _flat(share_obs),
                                  _flat(rnn_c), _flat(masks))
    rows = (lambda x: x) if layout == "by_env" else _flat
    values, rc = algo.get_values(state, rows(share_obs), rows(rnn_c),
                                 rows(masks))
    assert torch.equal(rc, rows(rnn_c))
    torch.testing.assert_close(_flat(values) if layout == "by_env"
                               else values, want, rtol=1e-6, atol=1e-7)
