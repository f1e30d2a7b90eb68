"""The port's host env pool against the JAX package's, on the CPU.

`envs/host_vec.py` (HostVecEnv: worker processes and shared-memory
blocks; DummyVecEnv: in-process), `envs/wrappers.StackedFrames`,
`envs/hanabi/hanabi_env.HanabiHostPoolEnv` and the space helpers of
`utils/spaces.py`, each driven beside its JAX counterpart with the same
envs, seeds and actions: every array of every step must be equal bit for
bit, and every info dict equal.

The envs here are deterministic and speak the reference's protocols:
`ScriptedSmacEnv` (6-tuple, share and choose) reaches per-agent death,
battles won and lost, truncation with `bad_transition` and the battle
counters within a few steps; `ScriptedFootballEnv` (4-tuple, basic)
ends every fifth step. `tests/test_torch_host_runner.py`
and `tests/test_torch_host_separated.py` train on them.
"""
import subprocess
import sys

import numpy as np
import pytest

from onpolicy_tpu.envs import host_vec as j_host_vec
from onpolicy_tpu.envs import wrappers as j_wrappers
from onpolicy_tpu.envs.hanabi import hanabi_env as j_hanabi
from onpolicy_tpu.utils import spaces as j_sp

from onpolicy_torch.envs import host_vec, wrappers
from onpolicy_torch.envs.hanabi import hanabi_env as t_hanabi
from onpolicy_torch.utils import spaces as sp


class ScriptedSmacEnv:
    """A deterministic SMAC-like env of the share protocol: M agents, obs
    (zeros for a dead agent) and state that follow from the step count
    and the last actions,
    rewards from the actions and the living agents. Each episode draws,
    from the seed and the count of episodes, when each agent dies and
    when the battle is won; it is lost when every agent is dead and cut
    at `limit` (`bad_transition`). A dead agent can only take action 0;
    an alive one any of 1..4 but one that changes with the step. With
    `decisive` false every episode is the same, agent 0 dies at step 3
    and the episode always runs to `limit`. Its spaces are those of
    `spaces` (the port's, or the JAX package's for JAX's pool)."""

    M, OBS, STATE, NACT = 3, 6, 8, 5

    def __init__(self, seed=0, limit=7, decisive=True, spaces=sp):
        self.seed_val, self.limit, self.decisive = seed, limit, decisive
        self.num_agents = self.M
        self.observation_space = [spaces.Box((self.OBS,))] * self.M
        self.share_observation_space = [spaces.Box((self.STATE,))] * self.M
        self.action_space = [spaces.Discrete(self.NACT)] * self.M
        self.episodes = self.battles_won = self.battles_game = 0
        self.reset()

    def reset(self):
        M = self.M
        if self.decisive:
            rng = np.random.default_rng([self.seed_val, self.episodes])
            self.die_at = rng.integers(2, 2 * self.limit, M)
            self.win_at = int(rng.integers(3, self.limit + 3))
        else:
            self.die_at = np.array([3] + [10 * self.limit] * (M - 1))
            self.win_at = 10 * self.limit
        self.episodes += 1
        self.t = 0
        self.last = np.zeros(M)
        return self._out()

    def _out(self):
        M, t, alive = self.M, self.t, self.t < self.die_at
        # a dead agent sees zeros, as in SMAC
        obs = np.stack([
            (np.sin(0.3 * t + 0.7 * i + np.arange(self.OBS) + self.seed_val)
             + 0.1 * self.last[i]) * alive[i] for i in range(M)])
        state = np.stack([
            np.cos(0.2 * t + 0.5 * i + np.arange(self.STATE) + self.seed_val)
            for i in range(M)])
        avail = np.zeros((M, self.NACT), np.float32)
        for i in range(M):
            if alive[i]:
                avail[i, 1:] = 1.0
                avail[i, 1 + (t + i) % 4] = 0.0
            else:
                avail[i, 0] = 1.0
        return obs.astype(np.float32), state.astype(np.float32), avail

    def step(self, actions):
        a = np.asarray(actions, np.float32).reshape(self.M)
        self.last = a
        self.t += 1
        alive = self.t < self.die_at
        rewards = np.full((self.M, 1), 0.1 * alive.sum() + a.mean() / 5,
                          np.float32)
        dones = ~alive
        won = bool(self.t >= self.win_at and alive.any())
        lost = not alive.any()
        cut = self.t >= self.limit and not (won or lost)
        if won or lost or cut:
            dones[:] = True
            self.battles_game += 1
            self.battles_won += int(won)
        info = {"won": won, "bad_transition": cut,
                "battles_won": self.battles_won,
                "battles_game": self.battles_game}
        obs, state, avail = self._out()
        return obs, state, rewards, dones, [dict(info) for _ in range(
            self.M)], avail

    def close(self):
        pass


class ScriptedFootballEnv:
    """A deterministic 4-tuple env (GRF-like: fully observed, one done for
    all players, the reward shared): episodes of 5 steps, a goal on the
    last step when the players' actions sum to an even number."""

    M, OBS = 2, 6

    def __init__(self, seed=0, spaces=sp):
        self.seed_val = seed
        self.num_agents = self.M
        self.observation_space = [spaces.Box((self.OBS,))] * self.M
        self.share_observation_space = [spaces.Box((self.OBS * self.M,))] \
            * self.M
        self.action_space = [spaces.Discrete(4)] * self.M
        self.t = 0

    def _obs(self, a):
        return np.cos(0.4 * self.t + 0.9 * np.arange(self.OBS)
                      + np.asarray(a, np.float32)[:, None]
                      + 0.1 * self.seed_val).astype(np.float32)

    def reset(self):
        self.t = 0
        return self._obs(np.zeros(self.M))

    def step(self, actions):
        a = np.asarray(actions).reshape(self.M)
        self.t += 1
        obs = self._obs(a)
        done = self.t >= 5
        goal = int(done and int(a.sum()) % 2 == 0)
        rew = np.full((self.M, 1), 0.5 + goal, np.float32)
        return obs, rew, np.full(self.M, done), \
            [{"score_reward": goal}] * self.M

    def close(self):
        pass


PROTOCOL_ENVS = {"share": ScriptedSmacEnv, "choose": ScriptedSmacEnv,
                 "basic": ScriptedFootballEnv}


def _drive(pool, protocol, n, steps=16):
    """Each step's outputs of `pool` under actions drawn from a fixed seed
    among the available ones; the choose protocol resets the envs that
    finished, by mask."""
    rng = np.random.default_rng(0)
    out = pool.reset()
    rows = [out]
    shared = protocol in ("share", "choose")
    for _ in range(steps):
        avail = out[-1] if shared else None
        M = pool.num_agents
        acts = np.zeros((n, M, 1), np.float32)
        for i in range(n):
            for m in range(M):
                legal = (np.nonzero(avail[i, m])[0] if avail is not None
                         else np.arange(4))
                acts[i, m, 0] = rng.choice(legal)
        out = pool.step(acts)
        rows.append(out)
        if protocol == "choose":
            done = np.asarray(out[3]).all(axis=1)
            if done.any():
                out = pool.reset(done)
                rows.append(out)
        if not shared:
            out = (out[0], None)
    return rows


def _assert_equal(got, want, where=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_equal(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, where


@pytest.mark.parametrize("protocol", sorted(PROTOCOL_ENVS))
@pytest.mark.parametrize("pool", ["HostVecEnv", "DummyVecEnv"])
def test_pool_streams_equal_jax(pool, protocol):
    """Reset, auto-reset (share, basic), masked reset (choose), per-agent
    death and `bad_transition`: every array and
    info of the port's pool equals JAX's, step for step."""
    n, env = 3, PROTOCOL_ENVS[protocol]
    make = lambda mod, spaces: getattr(mod, pool)(
        [lambda s=i: env(s, spaces=spaces) for i in range(n)],
        protocol=protocol)
    ours, theirs = make(host_vec, sp), make(j_host_vec, j_sp)
    try:
        got, want = _drive(ours, protocol, n), _drive(theirs, protocol, n)
        assert ours.num_agents == theirs.num_agents
        _assert_equal(got, want, protocol)
        if protocol in ("share", "choose"):
            dones = np.stack([r[3] for r in want if len(r) == 6])
            bad = [im["bad_transition"] for r in want if len(r) == 6
                   for info in r[4] for im in info]
            assert dones.any() and not dones.all() and any(bad)
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("protocol", sorted(PROTOCOL_ENVS))
def test_pool_close_ends_workers_and_frees_memory(protocol):
    """The workers are daemon processes; `close` ends every one of them
    and unlinks every shared-memory block, and a second `close` does
    nothing."""
    from multiprocessing import shared_memory
    env = PROTOCOL_ENVS[protocol]
    pool = host_vec.HostVecEnv([lambda s=i: env(s) for i in range(2)],
                               protocol=protocol)
    pool.reset()
    names = [name for name, _, _ in pool._specs.values()]
    assert all(p.daemon and p.is_alive() for p in pool._procs)
    pool.close()
    assert not any(p.is_alive() for p in pool._procs)
    for name in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)
    pool.close()


@pytest.mark.parametrize("space", ["Discrete(5)", "MultiDiscrete((3, 4))",
                                   "Box((2,))", "MultiBinary(3)"])
def test_action_width_matches_jax(space):
    """The width of the shared action block, from the port's spaces as
    JAX's pool reads its own."""
    want = j_host_vec.HostVecEnv._action_width(eval("j_sp." + space))
    assert host_vec.HostVecEnv._action_width(eval("sp." + space)) == want


def test_pool_modules_import_no_torch():
    """The workers run numpy and the env: the pool, the wrappers and the
    SMAC / GRF adapters and builders import no torch, so a worker forked
    from a process with a CUDA context never touches it."""
    mods = ["onpolicy_torch.envs.host_vec", "onpolicy_torch.envs.wrappers",
            "onpolicy_torch.envs.football.football_env"] + [
        f"onpolicy_torch.envs.starcraft2.{m}" for m in (
            "smac_maps", "state_builder", "obs_builder", "reward",
            "distributions", "v2_builders", "smac_env", "smacv2_env")]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "assert 'torch' not in sys.modules, 'torch imported'\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("k", [1, 3])
def test_stacked_frames_equal_jax(k):
    """Frames pushed by reset and step, never cleared across episodes (the
    reference's quirk), equal JAX's wrapper's array for array."""
    ours = wrappers.StackedFrames(ScriptedSmacEnv(1), k)
    theirs = j_wrappers.StackedFrames(ScriptedSmacEnv(1, spaces=j_sp), k)
    assert ours.observation_space == [sp.Box((ScriptedSmacEnv.OBS * k,))] * 3
    assert ours.share_observation_space[0].shape == \
        theirs.share_observation_space[0].shape
    _assert_equal(ours.reset(), theirs.reset())
    for t in range(12):
        a = np.full((3, 1), 1 + t % 4)
        _assert_equal(ours.step(a), theirs.step(a), f"step {t}")
    ours.close()
    theirs.close()


def test_space_helpers_match_jax():
    """obs_dim, env_action_dim, available_actions_dim and from_gym (gym's
    spaces told apart by class name; the port's own returned as they
    are)."""
    Box = type("Box", (), {"shape": (7,)})
    Disc = type("Discrete", (), {"n": 5})
    MD = type("MultiDiscrete", (), {"nvec": [3, 4]})
    MDold = type("MultiDiscrete", (), {"low": [0, 0], "high": [2, 5]})
    MB = type("MultiBinary", (), {"n": 3})

    class Tup:
        def __getitem__(self, i):
            return (Box(), Disc())[i]
    Tup.__name__ = "Tuple"
    for g in (Box(), Disc(), MD(), MDold(), MB(), Tup()):
        assert sp.from_gym(g) == sp.__dict__[type(
            j_sp.from_gym(g)).__name__](*vars(j_sp.from_gym(g)).values())
    for space in (sp.Box((3,)), sp.Discrete(4), sp.MultiDiscrete((2, 3))):
        assert sp.from_gym(space) is space
        assert sp.env_action_dim(space) == j_sp.env_action_dim(
            j_sp.from_gym(space))
    assert sp.obs_dim(sp.Box((9,))) == j_sp.obs_dim(j_sp.Box((9,))) == 9
    assert sp.available_actions_dim(sp.Discrete(6)) == 6
    with pytest.raises(ValueError):
        sp.obs_dim(sp.Box((2, 3)))
    with pytest.raises(TypeError):
        sp.available_actions_dim(sp.Box((2,)))


# ---------------------------------------------------------------------------
# HanabiHostPoolEnv on the C++ engine
# ---------------------------------------------------------------------------

NAME, M = "Hanabi-Very-Small", 2


def _hanabi_pool(mod, pool_cls, n, base_seed):
    fns = [lambda s=base_seed + i: mod.HanabiSingleEnv(NAME, M, seed=s)
           for i in range(n)]
    return mod.HanabiHostPoolEnv(pool_cls(fns, protocol="choose"), M)


def _drive_hanabi(env, n, steps=40):
    """First-legal-action games with masked resets of the finished ones:
    every output of reset and step."""
    rows = [env.reset()]
    avail = rows[0][2]
    for t in range(steps):
        acts = np.array([np.nonzero(avail[i] > 0)[0][t % int(
            (avail[i] > 0).sum())] if (avail[i] > 0).any() else -1
            for i in range(n)])
        out = env.step(acts)
        rows.append(out)
        avail = out[5]
        if out[3].any():
            r = env.reset(out[3])
            rows.append(r)
            avail = r[2]
    return rows


@pytest.mark.parametrize("pool", ["HostVecEnv", "DummyVecEnv"])
def test_hanabi_host_pool_equals_jax(pool):
    """The port's HanabiHostPoolEnv over one-game C++ engines in worker
    processes equals JAX's over its own engines, bit for bit: obs, share,
    rewards, done, current player, availability, scores, masked resets."""
    n = 3
    ours = _hanabi_pool(t_hanabi, getattr(host_vec, pool), n, 100)
    theirs = _hanabi_pool(j_hanabi, getattr(j_host_vec, pool), n, 100)
    try:
        assert (ours.obs_dim, ours.share_dim, ours.n_moves) == \
            (theirs.obs_dim, theirs.share_dim, theirs.n_moves)
        got, want = _drive_hanabi(ours, n), _drive_hanabi(theirs, n)
        _assert_equal(got, want, "hanabi pool")
        assert any(len(r) == 7 and r[3].any() for r in want)
    finally:
        ours.close()
        theirs.close()


def test_hanabi_runner_over_the_pool_equals_in_process():
    """The port's HanabiRunner over the pool of worker processes trains
    exactly as over the in-process pool (tests/test_host_ingestion_real.py
    on the port)."""
    from onpolicy_torch.runner.hanabi_runner import HanabiRunner
    from onpolicy_torch.scripts.train_hanabi import config_from_args

    def run(pool_cls):
        cfg = config_from_args([
            "--algorithm_name", "mappo", "--hanabi_name", NAME,
            "--num_agents", str(M), "--n_rollout_threads", "4",
            "--episode_length", "8", "--num_env_steps", "64",
            "--ppo_epoch", "2", "--hidden_size", "32", "--layer_N", "1",
            "--seed", "7", "--log_interval", "1", "--device", "cpu"])
        env = _hanabi_pool(t_hanabi, pool_cls, 4, 50)
        try:
            _, history = HanabiRunner(cfg, vec_env=env).run(log_fn=None)
        finally:
            env.close()
        return history

    pooled, direct = run(host_vec.HostVecEnv), run(host_vec.DummyVecEnv)
    assert len(pooled) == len(direct) > 0
    for a, b in zip(pooled, direct):
        assert a.keys() == b.keys()
        for k in a:
            if k != "fps":
                assert a[k] == b[k], k
