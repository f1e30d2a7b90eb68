"""The port's rendering against the JAX package's, on the CPU.

  * `utils/render.render_frame`: for each of the ten MPE scenarios, JAX's
    reset state converted by `utils/params.world_state_from_jax` gives
    the port a frame equal to JAX's bit for bit (the same matplotlib
    calls on the same float32 positions); JAX's own two checks of
    tests/test_render.py run on the port;
  * `save_gif` writes JAX's bytes, which imageio reads back to the
    frames; `save_video` returns JAX's path (the gif beside it where
    imageio has no ffmpeg);
  * `scripts/render_mpe.py`: from one checkpoint (JAX's, converted by
    `utils/params.train_state_from_jax`), the port's episode loop with
    JAX's reset states injected takes JAX's deterministic actions, and
    its episode rewards and world states agree with JAX's `main`'s;
    both write a gif an episode with --save_gifs, and both raise
    ValueError on scripts/render_mpe.sh's flags;
  * `scripts/render_football.py` over the GRF engine stand-in of
    `chip_smoke.py`: the same actions and rewards as JAX's from one
    converted checkpoint, the same files with --save_videos, and no file
    in either where the engine's renderer raises.

The frames are drawn with matplotlib's Agg backend (`render_frame` sets
it), so no display is needed.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from onpolicy_tpu.envs.mpe.env import MPEEnv as JMPEEnv
from onpolicy_tpu.utils import checkpoint as j_ckpt
from onpolicy_tpu.utils import render as j_render

from onpolicy_torch.envs.mpe.env import MPEEnv
from onpolicy_torch.envs.mpe.world import WorldState
from onpolicy_torch.utils import checkpoint as t_ckpt
from onpolicy_torch.utils import render
from onpolicy_torch.utils.params import (train_state_from_jax,
                                         world_state_from_jax)

# scenario: (num_agents, num_landmarks, num_good_agents, num_adversaries)
SCENARIOS = {
    "simple_spread": (3, 3, 1, 3),
    "simple_reference": (2, 3, 1, 3),
    "simple_speaker_listener": (2, 3, 1, 3),
    "simple_adversary": (3, 2, 1, 3),
    "simple_tag": (4, 2, 1, 3),
    "simple_push": (2, 2, 1, 3),
    "simple_crypto": (3, 2, 1, 3),
    "simple_crypto_display": (3, 2, 1, 3),
    "simple_attack": (4, 4, 2, 2),
    "simple_world_comm": (6, 1, 2, 4),
}


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    """JAX's render scripts would point jax at a persistent compile cache
    in the checkout."""
    monkeypatch.setenv("ONPOLICY_TPU_NO_COMPILE_CACHE", "1")


def _batched(jax_state):
    """An unbatched JAX `WorldState` → the port's, one world."""
    return world_state_from_jax(jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], jax_state))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_frame_equals_jax_bit_for_bit(scenario, seed):
    M, K, good, adv = SCENARIOS[scenario]
    jenv = JMPEEnv(scenario, M, K, 25, good, adv)
    state, _ = jenv.reset(jax.random.PRNGKey(seed))
    want = j_render.render_frame(jenv.spec, state, size=200)
    env = MPEEnv(scenario, M, K, 25, good, adv)
    got = render.render_frame(env.spec, _batched(state), size=200)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == (200, 200, 3)
    assert want.std() > 1.0
    np.testing.assert_array_equal(got, want)


def test_frame_reads_the_world_it_is_given():
    """`env` picks a world of the batch: the frame of world 1 of two is
    the frame of that world alone."""
    env = MPEEnv("simple_spread", 3, 3, 25)
    two, _ = env.reset(2, torch.Generator().manual_seed(4), "cpu")
    one = WorldState.from_tensors({k: v[1:]
                                   for k, v in two.tensors().items()})
    np.testing.assert_array_equal(
        render.render_frame(env.spec, two, size=120, env=1),
        render.render_frame(env.spec, one, size=120))
    assert not np.array_equal(
        render.render_frame(env.spec, two, size=120, env=0),
        render.render_frame(env.spec, one, size=120))


# ---- JAX's tests/test_render.py, on the port -------------------------------

def test_render_frame_and_gif(tmp_path):
    env = MPEEnv("simple_spread", 3, 3, 25)
    state, _ = env.reset(1, torch.Generator().manual_seed(0), "cpu")
    frame = render.render_frame(env.spec, state, size=200)
    assert frame.shape == (200, 200, 3)
    assert frame.dtype == np.uint8
    assert frame.std() > 1.0
    path = render.save_gif([frame, frame], tmp_path / "t.gif", fps=5)
    assert path.exists() and path.stat().st_size > 0


def test_render_golden_frame_geometry():
    """A fixed world on simple_tag: the good agent, the adversary and the
    landmarks found by their colour where their coordinates put them."""
    env = MPEEnv("simple_tag", 4, 2, 25)
    spec = env.spec
    state, _ = env.reset(1, torch.Generator().manual_seed(0), "cpu")
    M = spec.n_agents
    good = [i for i in range(M) if not spec.agent_adversary[i]][0]
    adv = [i for i in range(M) if spec.agent_adversary[i]][0]
    ap = np.zeros((M, 2), np.float32)
    ap[good] = (0.0, 0.0)
    ap[adv] = (0.7, 0.7)
    for i in range(M):
        if i not in (good, adv):
            ap[i] = (5.0, 5.0)
    lm = np.zeros((spec.n_landmarks, 2), np.float32)
    lm[0] = (-0.7, 0.0)
    for k in range(1, spec.n_landmarks):
        lm[k] = (0.0, -0.7)
    state = state.replace(agent_pos=torch.from_numpy(ap)[None],
                          landmark_pos=torch.from_numpy(lm)[None])
    size, bound = 400, 1.4
    frame = render.render_frame(spec, state, size=size,
                                bound=bound).astype(float)

    r, g, b = frame[..., 0], frame[..., 1], frame[..., 2]
    blue = (b > 120) & (b - r > 40) & (b - g > 40)
    red = (r > 120) & (r - b > 40) & (r - g > 40)
    dark = (np.abs(r - g) < 12) & (np.abs(g - b) < 12) & (r < 210) \
        & ~blue & ~red

    def centroid(mask):
        ys, xs = np.nonzero(mask)
        assert len(xs) > 20, "blob missing"
        return float(xs.mean()), float(ys.mean())

    cx, cy = size / 2, size / 2
    tol = 0.12 * size
    scale = size / (2 * bound)
    bx, by = centroid(blue)
    assert abs(bx - cx) < tol and abs(by - cy) < tol
    rx, ry = centroid(red)
    assert rx - cx > 0.5 * 0.7 * scale * 0.5
    assert cy - ry > 0.5 * 0.7 * scale * 0.5
    ys, xs = np.nonzero(dark)
    assert len(xs) > 40
    assert (xs < cx - 0.3 * scale).any() and (ys > cy + 0.3 * scale).any()
    if spec.agent_size[adv] > spec.agent_size[good]:
        assert red.sum() > blue.sum()


# ---- gif and video files ---------------------------------------------------

def _frames(n=4):
    env = MPEEnv("simple_tag", 4, 2, 25)
    states, _ = env.reset(n, torch.Generator().manual_seed(2), "cpu")
    return [render.render_frame(env.spec, states, size=96, env=i)
            for i in range(n)]


def test_save_gif_writes_jax_bytes(tmp_path):
    import imageio
    frames = _frames()
    ours = render.save_gif(frames, tmp_path / "t" / "a.gif", fps=4)
    theirs = j_render.save_gif(frames, tmp_path / "j" / "a.gif", fps=4)
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()
    back = imageio.mimread(str(ours))
    assert len(back) == len(frames)
    assert all(np.asarray(f)[..., :3].shape == frames[0].shape for f in back)


def test_save_video_returns_jax_path(tmp_path):
    frames = _frames()
    path = tmp_path / "v" / "episode_0.mp4"
    theirs = j_render.save_video(frames, path, fps=10)
    written = {p: p.read_bytes() for p in sorted(tmp_path.rglob("*"))
               if p.is_file()}
    for p in written:
        p.unlink()
    ours = render.save_video(frames, path, fps=10)
    assert str(ours) == str(theirs)
    assert {p: p.read_bytes() for p in sorted(tmp_path.rglob("*"))
            if p.is_file()} == written


# ---- render_mpe ------------------------------------------------------------

SPREAD = ["--env_name", "MPE", "--algorithm_name", "rmappo",
          "--scenario_name", "simple_spread", "--num_agents", "3",
          "--num_landmarks", "3", "--seed", "1", "--episode_length", "25",
          "--render_episodes", "2", "--hidden_size", "32", "--use_ReLU",
          "false"]


@pytest.fixture(scope="module")
def spread_checkpoints(tmp_path_factory):
    """One policy from a seed: JAX's checkpoint and the port's converted
    from it."""
    from onpolicy_tpu.config import config_from_args as j_config
    from onpolicy_tpu.runner.shared_runner import SharedRunner as JRunner
    root = tmp_path_factory.mktemp("spread")
    cfg = j_config(SPREAD, n_rollout_threads=1, use_render=True)
    state = JRunner(cfg).algo.init_state(jax.random.PRNGKey(11))
    j_ckpt.save(root / "jax", state)
    t_ckpt.save(root / "torch", train_state_from_jax(jax.device_get(state)),
                0, {})
    return root / "jax", root / "torch"


def _record_jax_main(monkeypatch, draw):
    """JAX's render_mpe with every world state it draws and every action
    it takes recorded (the drawing itself only with `draw`)."""
    from onpolicy_tpu.scripts import render_mpe as jrm
    seen = {"states": [], "actions": []}

    def frame(spec, state):
        seen["states"].append(jax.device_get(state))
        return j_render.render_frame(spec, state, size=64) if draw \
            else np.zeros((1, 1, 3), np.uint8)

    class Runner(jrm.SharedRunner):
        def __init__(self, cfg):
            super().__init__(cfg)
            act = self.algo.act

            def recorded(*a, **kw):
                out = act(*a, **kw)
                seen["actions"].append(np.asarray(out[0]))
                return out
            self.algo.act = recorded

    monkeypatch.setattr(jrm, "render_frame", frame)
    monkeypatch.setattr(jrm, "SharedRunner", Runner)
    return jrm, seen


def test_render_mpe_equals_jax(spread_checkpoints, monkeypatch, tmp_path):
    """2 episodes of 25 steps: JAX's `main` against the port's loop with
    JAX's first world of each episode injected."""
    from onpolicy_torch.scripts import render_mpe
    jdir, tdir = spread_checkpoints
    jrm, seen = _record_jax_main(monkeypatch, draw=False)
    monkeypatch.chdir(tmp_path)
    want = jrm.main(SPREAD + ["--model_dir", str(jdir)])
    T, E = 25, 2
    assert len(seen["states"]) == E * (T + 1)
    resets = [seen["states"][e * (T + 1)] for e in range(E)]

    cfg = render_mpe.config_from_args(
        SPREAD + ["--model_dir", str(tdir), "--device", "cpu"],
        n_rollout_threads=1, use_render=True)
    runner, state = render_mpe.load_policy(cfg)
    drawn = []

    def frame(spec, world):
        drawn.append(world)
        return np.zeros((1, 1, 3), np.uint8)
    got, actions = render_mpe.render_episodes(
        runner, state, frame, reset=lambda ep: _batched(resets[ep]))
    assert len(drawn) == len(seen["states"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want_actions = np.stack(seen["actions"]).reshape(E, T, 3, -1)
    for e in range(E):
        np.testing.assert_array_equal(actions[e].numpy(), want_actions[e])
    for ours, theirs in zip(drawn, seen["states"]):
        np.testing.assert_allclose(ours.agent_pos[0].numpy(),
                                   np.asarray(theirs.agent_pos),
                                   rtol=1e-5, atol=1e-5)
    assert not list(tmp_path.rglob("*.gif"))


def test_render_mpe_saves_a_gif_an_episode(spread_checkpoints, monkeypatch,
                                           tmp_path):
    from onpolicy_torch.scripts import render_mpe
    jdir, tdir = spread_checkpoints
    jrm, _ = _record_jax_main(monkeypatch, draw=True)
    flags = SPREAD + ["--save_gifs"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jrm.main(flags + ["--model_dir", str(jdir)])
    monkeypatch.chdir(tmp_path / "torch")
    rewards = render_mpe.main(flags + ["--model_dir", str(tdir),
                                       "--device", "cpu"])
    gifs = lambda d: sorted(p.relative_to(d) for p in d.rglob("*.gif"))
    assert gifs(tmp_path / "torch") == gifs(tmp_path / "jax") == [
        Path("gifs/simple_spread/episode_0.gif"),
        Path("gifs/simple_spread/episode_1.gif")]
    assert len(rewards) == 2 and np.all(np.isfinite(rewards))


RENDER_MPE_SH = ["--save_gifs", "--share_policy", "false", "--env_name",
                 "MPE", "--algorithm_name", "rmappo", "--experiment_name",
                 "check", "--scenario_name", "simple_speaker_listener",
                 "--num_agents", "2", "--num_landmarks", "3", "--seed", "1",
                 "--n_rollout_threads", "1", "--use_render",
                 "--episode_length", "25", "--render_episodes", "5"]


def test_render_mpe_sh_flags_raise_in_both(monkeypatch, tmp_path):
    """scripts/render_mpe.sh asks the shared runner for separated
    policies on heterogeneous observation spaces: both packages refuse."""
    from onpolicy_tpu.scripts import render_mpe as jrm
    from onpolicy_torch.scripts import render_mpe
    monkeypatch.chdir(tmp_path)
    flags = RENDER_MPE_SH + ["--model_dir", str(tmp_path / "none")]
    with pytest.raises(ValueError, match="homogeneous"):
        jrm.main(flags)
    with pytest.raises(ValueError, match="homogeneous"):
        render_mpe.main(flags + ["--device", "cpu"])
    assert not list(tmp_path.rglob("*"))


@pytest.mark.parametrize("script", ["render_mpe", "render_football"])
def test_render_scripts_refuse_a_missing_card(script, monkeypatch):
    """No fallback to the CPU: --device cuda (the default) without a card
    raises, as the other entry points do."""
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setitem(sys.modules, "gfootball", None)
    module = importlib.import_module(f"onpolicy_torch.scripts.{script}")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(["--render_episodes", "1"])


# ---- render_football -------------------------------------------------------

FOOTBALL = ["--env_name", "Football", "--scenario_name",
            "academy_3_vs_1_with_keeper", "--algorithm_name", "rmappo",
            "--experiment_name", "render", "--seed", "1", "--num_agents",
            "3", "--representation", "simple115v2", "--use_render",
            "--render_episodes", "2", "--n_rollout_threads", "1",
            "--hidden_size", "32"]


@pytest.fixture()
def standins(monkeypatch):
    for name, mod in chip_smoke.engine_standin_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)


@pytest.fixture(scope="module")
def football_checkpoints(tmp_path_factory):
    """One GRF policy from a seed: JAX's checkpoint, the port's converted
    from it."""
    from onpolicy_tpu.algorithms.mappo import MAPPO as JMAPPO
    from onpolicy_tpu.scripts import render_football as jrf
    mp = pytest.MonkeyPatch()
    for name, mod in chip_smoke.engine_standin_modules().items():
        mp.setitem(sys.modules, name, mod)
    try:
        from onpolicy_tpu.envs.football.football_env import FootballEnv
        from onpolicy_tpu.config import Config, canonicalize_algorithm
        ns = jrf.parse_args(FOOTBALL)
        cfg = canonicalize_algorithm(Config(**{
            k: v for k, v in vars(ns).items()
            if k in Config.__dataclass_fields__})).validate()
        env = FootballEnv(num_agents=3)
        algo = JMAPPO(cfg, env.observation_space[0],
                      env.share_observation_space[0], env.action_space[0])
        state = algo.init_state(jax.random.PRNGKey(5))
    finally:
        mp.undo()
    root = tmp_path_factory.mktemp("football")
    j_ckpt.save(root / "jax", state)
    t_ckpt.save(root / "torch", train_state_from_jax(jax.device_get(state)),
                0, {})
    return root / "jax", root / "torch"


def _recording_env(module, seen):
    """`module.FootballEnv` with every action taken and reward given
    recorded in `seen`."""
    class Recording(module.FootballEnv):
        def step(self, actions):
            out = super().step(actions)
            seen.append((np.asarray(actions).reshape(-1).copy(), out[1]))
            return out
    return Recording


def _run_football(monkeypatch, tmp_path, checkpoints, flags):
    """JAX's and the port's main on `flags`, each in its own directory
    under `tmp_path` → (JAX's steps, the port's steps, the port's episode
    rewards)."""
    import onpolicy_tpu.envs.football.football_env as j_fe
    import onpolicy_torch.envs.football.football_env as t_fe
    from onpolicy_tpu.scripts import render_football as jrf
    from onpolicy_torch.scripts import render_football
    jdir, tdir = checkpoints
    theirs, ours = [], []
    monkeypatch.setattr(j_fe, "FootballEnv", _recording_env(j_fe, theirs))
    monkeypatch.setattr(t_fe, "FootballEnv", _recording_env(t_fe, ours))
    (tmp_path / "jax").mkdir(parents=True)
    (tmp_path / "torch").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jrf.main(FOOTBALL + flags("jax") + ["--model_dir", str(jdir)])
    monkeypatch.chdir(tmp_path / "torch")
    rewards = render_football.main(FOOTBALL + flags("torch") + [
        "--model_dir", str(tdir), "--device", "cpu"])
    return theirs, ours, rewards


def _files(d):
    return {p.relative_to(d): p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file()}


def test_render_football_equals_jax(standins, football_checkpoints,
                                    monkeypatch, tmp_path, capsys):
    theirs, ours, rewards = _run_football(monkeypatch, tmp_path,
                                          football_checkpoints,
                                          lambda side: [])
    assert len(ours) == len(theirs) > 2
    for (a, r), (ja, jr) in zip(ours, theirs):
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_allclose(r, jr, rtol=1e-5, atol=1e-5)
    out = capsys.readouterr().out.splitlines()
    lines = [l for l in out if l.startswith("episode ")]
    assert lines[:2] == lines[2:] and len(lines) == 4
    assert lines[2:] == [f"episode {e}: reward {r:.2f}"
                         for e, r in enumerate(rewards)]
    assert not _files(tmp_path)


@pytest.mark.parametrize("render_fails", [False, True])
def test_render_football_saves_videos_as_jax(standins, football_checkpoints,
                                             monkeypatch, tmp_path,
                                             render_fails):
    """--save_videos into --video_dir: the same files in both packages
    (here gifs, as imageio has no ffmpeg); where the engine's renderer
    raises, no frame and no file in either."""
    if render_fails:
        def broken(self, mode="rgb_array"):
            raise RuntimeError("no display")
        monkeypatch.setattr(chip_smoke.StandInFootballEnv, "render", broken)
    videos = tmp_path / "videos"
    flags = lambda side: ["--save_videos", "--video_dir",
                          str(videos / side)]
    theirs, ours, _ = _run_football(monkeypatch, tmp_path / "run",
                                    football_checkpoints, flags)
    assert len(ours) == len(theirs)
    got, want = _files(videos / "torch"), _files(videos / "jax")
    assert got == want
    if render_fails:
        assert not want and not _files(tmp_path / "run")
    else:
        assert sorted(p.stem for p in want) == ["episode_0", "episode_1"]
