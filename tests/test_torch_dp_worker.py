"""Data-parallel cases of the port, and the worker that runs them as one
rank of a gloo process group on the CPU.

    python tests/test_torch_dp_worker.py RANK WORLD STORE JOB OUT [IN ...]

joins a group of WORLD ranks through a `FileStore` at STORE, runs the
cases of JOB ("device": the MPE runners and the trainers on a JAX
episode given in IN; "host": the host runners; "model12" / "model22":
both on the (data, model) mesh (1, 2) / (2, 2), the trainers on JAX's
(2, 2) episodes in IN) and writes what each case trained (the
parameters, the logged rows; on a model axis also each rank's kept
blocks) to OUT with `torch.save`. The same case functions, called in one
process without a group, give the one-rank reference
(`tests/test_torch_parallel.py`, `tests/test_torch_parallel_host.py`,
`tests/test_torch_parallel_2d.py`). The worker imports no JAX (it
asserts so at its end): the port's data-parallel path needs none. The
module holds no tests of its own.
"""
from __future__ import annotations

import math
import os
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from onpolicy_torch.config import Config, canonicalize_algorithm  # noqa: E402
from onpolicy_torch.parallel import distributed  # noqa: E402
from onpolicy_torch.utils import spaces as sp  # noqa: E402
from onpolicy_torch.utils.tree import tree_leaves  # noqa: E402

# the MPE cases: flags of a tiny run each. rmappo_chunks cuts the global
# N·M·T = 450 steps into 56 chunks of L=8 (2 minibatches of 28, 14 a
# rank), while a rank's 225 steps are no multiple of 8: chunks straddle
# agents, episodes and ranks
MPE_BASE = dict(scenario_name="simple_spread", num_agents=3,
                num_landmarks=3, hidden_size=16, n_embd=16, lr=7e-4,
                critic_lr=7e-4, use_ReLU=False, seed=3, log_interval=1,
                device="cpu")
DEVICE_CASES = {
    "rmappo_chunks": dict(algorithm_name="rmappo", n_rollout_threads=6,
                          episode_length=25, data_chunk_length=8,
                          num_mini_batch=2, ppo_epoch=2, episodes=2),
    "mappo": dict(algorithm_name="mappo", n_rollout_threads=4,
                  episode_length=10, num_mini_batch=2, ppo_epoch=2,
                  episodes=2),
    "mappo_dedup": dict(algorithm_name="mappo", n_rollout_threads=4,
                        episode_length=10, ppo_epoch=2,
                        use_critic_dedup=True, episodes=1),
    "mat": dict(algorithm_name="mat", n_rollout_threads=4,
                episode_length=10, num_mini_batch=2, ppo_epoch=2,
                episodes=2),
    "happo": dict(algorithm_name="happo", n_rollout_threads=4,
                  episode_length=10, data_chunk_length=5, ppo_epoch=2,
                  episodes=1),
    "hatrpo": dict(algorithm_name="hatrpo", n_rollout_threads=4,
                   episode_length=10, data_chunk_length=5, episodes=1),
}
# the (data, model) jobs' mesh shapes, and what they add: MAPPO with
# PopArt (the trainer rescales the gathered value head and cuts it)
MODEL_JOBS = {"model12": (1, 2), "model22": (2, 2)}
POPART_CASE = dict(algorithm_name="mappo", n_rollout_threads=4,
                   episode_length=10, num_mini_batch=2, ppo_epoch=2,
                   use_popart=True, use_valuenorm=False, episodes=2)
# rmappo_chunks's 6 threads do not split over 4 ranks. At 8 threads its
# T=25 and L=8 give 75 chunks, which make no 2 minibatches (nor does any
# T that L=8 does not divide); T=17 and L=10 give 40 chunks (8 steps
# dropped), 2 minibatches of 20, 5 a rank, and a rank's 2·3·17 = 102
# steps are no multiple of 10: chunks still straddle agents, episodes and
# ranks
FOUR_RANKS = {"rmappo_chunks": dict(n_rollout_threads=8, episode_length=17,
                                    data_chunk_length=10)}


def device_case(name, ranks=1, four_ranks=False) -> dict:
    """The flags of MPE case `name` (the ones `FOUR_RANKS` gives it where
    its threads do not split over 4 ranks, for a run on 4 or its
    one-process reference: `four_ranks`)."""
    case = POPART_CASE if name == "mappo_popart" else DEVICE_CASES[name]
    if four_ranks or ranks == 4:
        case = {**case, **FOUR_RANKS.get(name, {})}
    return case


# the host cases: 8 envs in all (8 on one rank, 4 on each of two)
HOST_ENVS = 8
HOST_BASE = dict(hidden_size=16, lr=7e-4, critic_lr=7e-4, seed=5,
                 episode_length=12, data_chunk_length=4, ppo_epoch=2,
                 log_interval=1, device="cpu")
HOST_CASES = {
    "host_rmappo": dict(algorithm_name="rmappo", num_mini_batch=2,
                        episodes=2, pool="HostVecEnv"),
    "host_happo": dict(algorithm_name="happo", episodes=1,
                       pool="DummyVecEnv"),
}


class DeadAgentSmacEnv:
    """A deterministic SMAC-like env of the share protocol, 3 agents: obs
    and state follow from the env's seed (its global index), the step and
    the last actions, and vary across features; a dead agent sees zeros
    and may only take action 0. Each episode draws from the seed when
    each agent dies; an episode ends when all are dead or at 7 steps
    (`bad_transition`)."""

    M, OBS, STATE, NACT, LIMIT = 3, 6, 8, 5, 7

    def __init__(self, seed=0):
        self.seed_val = seed
        self.num_agents = self.M
        self.observation_space = [sp.Box((self.OBS,))] * self.M
        self.share_observation_space = [sp.Box((self.STATE,))] * self.M
        self.action_space = [sp.Discrete(self.NACT)] * self.M
        self.episodes = self.battles_won = self.battles_game = 0

    def reset(self):
        rng = np.random.default_rng([self.seed_val, self.episodes])
        self.die_at = rng.integers(2, 2 * self.LIMIT, self.M)
        self.episodes += 1
        self.t = 0
        self.last = np.zeros(self.M)
        return self._out()

    def _out(self):
        t, alive = self.t, self.t < self.die_at
        obs = np.stack([
            (np.sin(0.3 * t + 0.7 * i + np.arange(self.OBS) + self.seed_val)
             + 0.1 * self.last[i]) * alive[i] for i in range(self.M)])
        state = np.stack([
            np.cos(0.2 * t + 0.5 * i + np.arange(self.STATE)
                   + 0.3 * self.seed_val) for i in range(self.M)])
        avail = np.zeros((self.M, self.NACT), np.float32)
        avail[alive, 1:] = 1.0
        avail[~alive, 0] = 1.0
        return obs.astype(np.float32), state.astype(np.float32), avail

    def step(self, actions):
        self.last = np.asarray(actions, np.float32).reshape(self.M)
        self.t += 1
        alive = self.t < self.die_at
        rewards = (0.1 * self.last * alive).reshape(self.M, 1)
        done = not alive.any() or self.t >= self.LIMIT
        dones = ~alive if not done else np.ones(self.M, bool)
        if done:
            self.battles_game += 1
            self.battles_won += int(alive.any())
        info = {"battles_won": self.battles_won,
                "battles_game": self.battles_game,
                "bad_transition": bool(alive.any() and done)}
        obs, state, avail = self._out()
        return obs, state, rewards, dones, [dict(info)] * self.M, avail

    def close(self):
        pass


def _shape(mesh):
    """A rank count R (the mesh (R,)) or a mesh shape → the shape."""
    return (mesh,) if isinstance(mesh, int) else tuple(mesh)


def _cfg(base, case, mesh):
    flags = {k: v for k, v in {**base, **case}.items()
             if k not in ("episodes", "pool")}
    return canonicalize_algorithm(Config(**flags, mesh_shape=_shape(mesh)))


def _kept(states, algos) -> list:
    """Each trainer's parameter and moment trees (params, μ, ν of each
    parameter field), leaf by leaf, as its state holds them."""
    return [x.detach().cpu().clone() for s, a in zip(states, algos)
            for p, o in a.shards.fields
            for x in tree_leaves((getattr(s, p), getattr(s, o)["mu"],
                                  getattr(s, o)["nu"]))]


def _trained(state, history, runner) -> dict:
    """What a run trained: the full parameters (gathered on a model
    axis, on every rank), the logged rows; on a model axis also the
    rank's kept blocks of the parameters and moments, the same leaves
    gathered, and the leaf rule's dims."""
    states = state if isinstance(state, tuple) else (state,)
    algos = getattr(runner, "algos", None) or [getattr(runner, "algo",
                                                       None)]
    out = {}
    if getattr(runner, "mesh", None) is not None and \
            runner.mesh.model_size > 1:
        full = runner._state(state, "full")
        full = full if isinstance(full, tuple) else (full,)
        out = {"kept": _kept(states, algos), "full": _kept(full, algos),
               "dims": [d for a in algos for p, _ in a.shards.fields
                        for d in a.shards.layouts[p].dims * 3],
               "model_rank": runner.mesh.model_rank}
        states = full
    params = [x.detach().cpu().clone() for s in states
              for x in tree_leaves(s.params if hasattr(s, "params") else
                                   (s.actor_params, s.critic_params))]
    rows = [{k: v for k, v in r.items() if k != "fps"} for r in history]
    return {"params": params, "rows": rows,
            "N": getattr(runner, "N", None),
            "episodes": getattr(runner, "episodes", None), **out}


def run_device_case(name, ranks, save_dir=None, model_dir=None,
                    episodes=None, four_ranks=False) -> dict:
    """One MPE case through `train_mpe.make_runner` on `ranks` ranks (1:
    one process, no group; or a mesh shape), its episodes (or `episodes`
    in all, resumed from the checkpoint in `model_dir`) through `run`."""
    from onpolicy_torch.scripts.train_mpe import make_runner
    case = device_case(name, math.prod(_shape(ranks)), four_ranks)
    T = case["episode_length"]
    cfg = _cfg(MPE_BASE, case, ranks).replace(
        num_env_steps=(episodes or case["episodes"]) * T
        * case["n_rollout_threads"], model_dir=model_dir)
    runner = make_runner(cfg)
    state, history = runner.run(log_fn=None, save_dir=save_dir)
    return _trained(state, history, runner)


def host_env_fns(n, first):
    return [lambda s=first + i: DeadAgentSmacEnv(s) for i in range(n)]


def run_host_case(name, ranks) -> dict:
    """One host case: each of `ranks` ranks owns HOST_ENVS / ranks envs of
    `DeadAgentSmacEnv`, env i of rank r seeded with its global index."""
    from onpolicy_torch.envs import host_vec
    from onpolicy_torch.envs.starcraft2.smac_env import \
        smac_win_rate_metrics
    from onpolicy_torch.runner.host_runner import HostSharedRunner
    from onpolicy_torch.runner.host_separated_runner import \
        HostSeparatedRunner
    from onpolicy_torch.runner.host_mesh import env_offset
    case = HOST_CASES[name]
    n = HOST_ENVS // math.prod(_shape(ranks))
    cfg = _cfg(HOST_BASE, case, ranks).replace(
        n_rollout_threads=n, num_env_steps=case["episodes"]
        * HOST_BASE["episode_length"] * HOST_ENVS)
    Pool = getattr(host_vec, case["pool"])
    envs = Pool(host_env_fns(n, env_offset(n)), protocol="share")
    Runner = HostSeparatedRunner if cfg.algorithm_name == "happo" \
        else HostSharedRunner
    try:
        runner = Runner(cfg, envs, env_metrics=smac_win_rate_metrics())
        state, history = runner.run(log_fn=None)
    finally:
        envs.close()
    return _trained(state, history, runner)


# the training scripts end to end at a tiny size: the flagship's flags
# (4 threads in all, T=25: 30 chunks of L=10, 15 a rank) and
# train_smac_3s5z.sh's over the engine stand-ins of chip_smoke.py (2
# envs in all, T=20, an eval of one episode on rank 0)
MAIN_MPE = ["--n_rollout_threads", "4", "--num_env_steps", "200",
            "--hidden_size", "16", "--ppo_epoch", "2", "--log_interval", "1",
            "--device", "cpu"]
MAIN_SMAC = ["--episode_length", "20", "--num_env_steps", "80",
             "--hidden_size", "16", "--ppo_epoch", "2", "--eval_episodes",
             "1", "--log_interval", "1", "--device", "cpu"]


def run_main(script, ranks) -> dict:
    """`scripts/<script>.main` at MAIN_MPE / MAIN_SMAC with --mesh_shape
    `ranks` (train_smac: 2 / ranks threads a rank, over the engine
    stand-ins, which the caller installs)."""
    import importlib
    module = importlib.import_module(f"onpolicy_torch.scripts.{script}")
    if script == "train_mpe":
        argv = module.CONFIGS["flagship"] + MAIN_MPE
    else:
        argv = module.CONFIGS["smac_3s5z"] + MAIN_SMAC + [
            "--n_rollout_threads", str(2 // ranks)]
    state, history = module.main(argv + ["--mesh_shape", str(ranks)])
    return _trained(state, history, None)


def train_jax_episode(path, ranks) -> dict:
    """The trainer of the shared runner over `ranks` ranks (or a mesh
    shape) on the episode saved at `path` (a JAX episode's buffer, the
    state it started from and each epoch's permutation): → the trained
    state (whole, gathered on a model axis) and the metrics."""
    from onpolicy_torch import buffer as buf_lib
    from onpolicy_torch.scripts.train_mpe import make_runner
    given = torch.load(path, weights_only=False)
    cfg = canonicalize_algorithm(Config(**given["flags"], device="cpu",
                                        mesh_shape=_shape(ranks)))
    runner = make_runner(cfg)
    buf = buf_lib.RolloutBuffer(**given["buf"])
    shards = runner.algo.shards
    state, metrics = runner.algo.train(shards.cut(given["state"]), buf,
                                       None, perms=given["perms"])
    return {"state": shards.full(state),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def train_jax_separated(path, mesh) -> dict:
    """The separated runner's update over the mesh `mesh` on the
    separated episode saved at `path` (each agent's JAX buffer, the
    states it started from, the agent order): → the trained states
    (whole) and the metrics."""
    from onpolicy_torch import buffer as buf_lib
    from onpolicy_torch.scripts.train_mpe import make_runner
    given = torch.load(path, weights_only=False)
    cfg = canonicalize_algorithm(Config(**given["flags"], device="cpu",
                                        mesh_shape=_shape(mesh)))
    runner = make_runner(cfg)
    bufs = [buf_lib.RolloutBuffer(**b) for b in given["bufs"]]
    states, metrics = runner.update(
        runner._state(tuple(given["states"]), "cut"), bufs, given["order"])
    return {"states": runner._state(states, "full"),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def main(argv):
    rank, world, store, job, out = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    distributed.initialize(
        rank=rank, world_size=world, backend="gloo", device="cpu",
        store=torch.distributed.FileStore(store, world))
    results = {}
    if job == "device":
        results["jax_episode"] = train_jax_episode(argv[5], world)
        models = str(Path(out).parent / "models")
        for name in DEVICE_CASES:
            results[name] = run_device_case(
                name, world, models if name == "rmappo_chunks" and rank == 0
                else None)
        # every rank restores the checkpoint rank 0 wrote, for a third
        # episode
        torch.distributed.barrier()
        results["rmappo_resumed"] = run_device_case(
            "rmappo_chunks", world, model_dir=models, episodes=3)
    elif job in MODEL_JOBS:
        shape = MODEL_JOBS[job]
        one_models, models = argv[5], str(Path(out).parent / f"{job}_models")
        cases = [*DEVICE_CASES, "mappo_popart"]
        if job == "model22":
            results["jax_episode"] = train_jax_episode(argv[6], shape)
            results["jax_separated"] = train_jax_separated(argv[7], shape)
        for name in cases:
            results[name] = run_device_case(
                name, shape, models if name == "rmappo_chunks" and rank == 0
                else None)
        if job == "model12":
            # a one-process checkpoint, resumed under (1, 2) for a third
            # episode
            results["rmappo_resumed"] = run_device_case(
                "rmappo_chunks", shape, model_dir=one_models, episodes=3)
            for name in HOST_CASES:
                results[name] = run_host_case(name, shape)
    elif job == "host":
        for name in HOST_CASES:
            results[name] = run_host_case(name, world)
        import chip_smoke
        chip_smoke.install_engine_standins()
        for script in ("train_mpe", "train_smac"):
            results[script] = run_main(script, world)
    else:
        raise ValueError(f"unknown job {job!r}")
    assert "jax" not in sys.modules, "the data-parallel path imported jax"
    torch.save(results, out)
    distributed.shutdown()


if __name__ == "__main__":
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    main(sys.argv[1:])
