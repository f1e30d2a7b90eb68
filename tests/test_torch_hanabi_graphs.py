"""The tensor engine's fleet as CUDA graphs (`torch_fleet._Graphs`).

On the CPU: the step, reset and observation chains build no tensor from
host data once the engine's tables exist (a CUDA graph cannot capture a
copy from the host), and the fleet runs them op by op, replaying
nothing, with the outputs of `te.step` + `observe` and of the masked
reset + `observe` called directly.

Marked `cuda`, skipped where there is no CUDA device: two runners on the
device round (`--use_jax_env --use_scan_rounds`) from one seed, one with
the fleet's graphs and one forced op by op, in turns through a
collecting and a trained episode; every buffer field, the carry, the
episode's metrics and the shared generator's state are bit for bit
equal, and the graphed fleet replays (M + 1)·T graphs an episode. The
file imports neither JAX nor the JAX package, so the card's machine runs
it on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_hanabi_graphs.py
"""
import contextlib

import pytest
import torch

from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.envs.hanabi import torch_engine as te
from onpolicy_torch.envs.hanabi.torch_fleet import TorchHanabiFleet
from onpolicy_torch.runner.hanabi_runner import HanabiRunner
from onpolicy_torch.utils import profiling

CARD_FLAGS = dict(env_name="Hanabi", scenario_name="Hanabi-Full",
                  algorithm_name="rmappo", num_agents=2, n_rollout_threads=64,
                  episode_length=20, num_env_steps=2560, hidden_size=64,
                  ppo_epoch=2, use_jax_env=True, use_scan_rounds=True)


def _fleet(name, n, obs_instead, seed=0):
    return TorchHanabiFleet(name, 2, n, torch.device("cpu"),
                            torch.Generator().manual_seed(seed),
                            use_obs_instead_of_state=obs_instead)


def _legal_actions(avail, generator):
    """One legal move a game (−1 where none), drawn from `generator`."""
    keys = torch.rand(avail.shape, generator=generator) * avail
    return torch.where(avail.any(1), keys.argmax(1), -1)


def _same(got, want, where):
    assert len(got) == len(want), where
    for i, (a, b) in enumerate(zip(got, want)):
        if isinstance(a, te.HanabiState):
            for k, v in a.tensors().items():
                assert torch.equal(v, getattr(b, k)), f"{where} state {k}"
        else:
            assert torch.equal(a, b), f"{where} output {i}"


@pytest.mark.parametrize("name, obs_instead", [("Hanabi-Full", False),
                                               ("Hanabi-Small", True)])
def test_chains_build_no_tensor_from_host_data(name, obs_instead,
                                               monkeypatch):
    fleet = _fleet(name, 5, obs_instead)
    states = fleet.reset_states()
    avail = fleet.observe(states)[2]          # the tables are built
    acts = _legal_actions(avail, torch.Generator().manual_seed(1))
    mask = torch.tensor([True, False, True, False, False])

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor built from host data")
    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    for _ in range(6):
        states = fleet.pure_step(states, acts)[0]
        acts = _legal_actions(fleet.observe(states)[2],
                              torch.Generator().manual_seed(2))
    states = fleet.masked_reset(states, mask)
    fleet.reset_observe(states, ~mask)
    fleet.observe(states)


@pytest.mark.parametrize("name, obs_instead", [("Hanabi-Full", True),
                                               ("Hanabi-Small", False)])
def test_cpu_fleet_runs_the_chains_op_by_op(name, obs_instead):
    """The eager path on the CPU: no graph, no replay counted, and the
    outputs of the engine's functions called directly."""
    N, M = 6, 2
    fleet = _fleet(name, N, obs_instead, seed=4)
    twin = torch.Generator().manual_seed(4)    # the fleet's draws, replayed
    pick = torch.Generator().manual_seed(5)
    states = fleet.reset_states()
    want = te.reset_with_deck(fleet.game,
                              te.shuffled_decks(fleet.game, N, twin, "cpu"))
    _same([states], [want], "reset_states")
    saw_reset = False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for t in range(40):
            acts = _legal_actions(fleet.observe(states)[2], pick)
            got = fleet.pure_step(states, acts)
            new, rew = te.step(fleet.game, states, acts)
            obs, share, avail, _, done, score = fleet.observe(new)
            _same(got, (new, obs, share,
                        rew[:, None, None].expand(N, M, 1), done, avail,
                        score), f"step {t}")
            mask = got[4]
            got = fleet.reset_observe(got[0], mask)
            fresh = te.reset_with_deck(
                fleet.game, te.shuffled_decks(fleet.game, N, twin, "cpu"))
            want = fresh.where(mask, new)
            _same(got, (want, *fleet.observe(want)), f"reset {t}")
            saw_reset = saw_reset or bool(mask.any())
            states = got[0]
        counters = profiling.take()["counters"]
    assert saw_reset
    assert fleet._graphs is None
    assert counters.get("env_graph_replays", 0) == 0


def _tensors(x):
    """{name: tensor} of a carry, a buffer or the episode's metrics."""
    out = {}
    for k, v in x.items():
        if isinstance(v, te.HanabiState):
            out.update({f"{k}.{f}": t for f, t in v.tensors().items()})
        elif torch.is_tensor(v):
            out[k] = v
    return out


@pytest.mark.cuda
def test_graphed_fleet_matches_op_by_op_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs run on the card only")
    cfg = canonicalize_algorithm(Config(**CARD_FLAGS, device="cuda"))
    M, T = cfg.num_agents, cfg.episode_length
    graphed, eager = HanabiRunner(cfg), HanabiRunner(cfg)
    eager.envs._graphs_for = lambda states: None      # op by op
    runs = [list(r.init()) for r in (graphed, eager)]
    saw_reset = False
    for episode in range(2):
        outs, replays = [], []
        for runner, run in zip((graphed, eager), runs):
            # the graphs are captured in the first episode, unprofiled
            counting = (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
                if episode else contextlib.nullcontext())
            with counting:
                ts, carry, dbuf, metrics = runner.episode(
                    *run, do_train=episode > 0)
                torch.cuda.synchronize()
            replays.append(profiling.take()["counters"].get(
                "env_graph_replays", 0))
            run[:] = [ts, carry, dbuf]
            outs.append([_tensors(x) for x in (carry, dbuf, metrics)])
        for part, got, want in zip(("carry", "buffer", "metrics"), *outs):
            assert got.keys() == want.keys(), part
            for k in got:
                assert torch.equal(got[k], want[k]), \
                    f"episode {episode} {part} {k}"
        assert torch.equal(graphed.generator.get_state(),
                           eager.generator.get_state()), episode
        if episode:
            assert replays == [(M + 1) * T, 0]
        saw_reset = saw_reset or bool(outs[0][1]["masks"].eq(0).any())
    assert saw_reset
    assert graphed.envs._graphs is not None and eager.envs._graphs is None

    # a state returned before the fleet's last step is refused
    fleet = graphed.envs
    kept = runs[0][1]["env_states"]
    noop = torch.full((fleet.n_envs,), -1, device="cuda")
    fleet.pure_step(kept, noop)
    with pytest.raises(ValueError, match="overwritten"):
        fleet.pure_step(kept, noop)
