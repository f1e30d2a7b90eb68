"""What the shared and the separated runner have in common.

The set-up (config, device, generators, the env and the eval env, the
mesh), checkpoints, and the host training loop `run` of the JAX
package's `runner/shared_runner.py:262-333`:
`episodes_per_call` = E episodes per call with their metrics averaged;
logging, eval and saving on its `% E` schedule; a `torch.profiler` trace
of the call that covers episodes 2 <= episode < 2 + E when `profile_dir`
is set.

A runner provides `init() → (state, carry)`, `episode(state, carry) →
(state, carry, metrics)` and `eval_episode(state) → mean return`.

All randomness on the path (action draws, env resets, minibatch
permutations) comes from one `torch.Generator` on the run's device,
seeded with cfg.seed; parameters are drawn from a CPU generator with the
same seed. The eval env draws from its own generator.

Data parallelism (`--mesh_shape R` under torchrun; `parallel/mesh.py`):
`n_rollout_threads` is the global env count, as in the JAX package's
device runners, and each rank steps its block `mesh.rows(N)` of the
envs. Every draw is made at the global shape from the run's generator
and cut to the rank's rows (`distributed.RowDraws`; the env's resets and
noise likewise), so R ranks draw what one draws. The episode is
gathered in rank order into the whole buffer (`_gather_episode`) before
the returns and the update. Rank 0 logs, traces and writes the
checkpoints, whose carry is gathered into the global one; every rank
restores it and takes its rows, so a checkpoint does not depend on R.

On a `(data, model)` mesh (`--mesh_shape D,M` under torchrun with D·M
ranks) the rows split over all D·M ranks as above, and each rank keeps
its blocks of the trainers' parameters and moments (`parallel/mesh.py`).
The rollout and the eval act with the full parameters, gathered over the
model group once before them on every rank (the eval env is rank 0's,
the gather every rank's); the checkpoint holds the whole state,
gathered on every rank and written by rank 0, and a restore cuts each
rank's blocks: a checkpoint depends on neither D nor M (`_state`).
"""
from __future__ import annotations

import time

import torch

from onpolicy_torch.envs.mpe import make_vec_env
from onpolicy_torch.envs.mpe.world import WorldState
from onpolicy_torch.parallel import distributed
from onpolicy_torch.parallel import mesh as mesh_lib
from onpolicy_torch.utils import checkpoint as ckpt_lib
from onpolicy_torch.utils import profiling
from onpolicy_torch.utils.tree import tree_leaves, tree_unflatten


def gather_carry(carry, mesh):
    """A carry tree whose leaves lead with this rank's envs → the global
    carry (every rank's rows in rank order; one all-reduce a dtype)."""
    if mesh is None:
        return carry
    leaves = tree_leaves(carry)
    out = distributed.gather_rows(dict(enumerate(leaves)), 0, mesh)
    return tree_unflatten(carry, [out[i] for i in range(len(leaves))])


def local_carry(carry, mesh):
    """A global carry tree → this rank's rows of it."""
    if mesh is None:
        return carry
    return tree_unflatten(carry, [x[mesh.rows(x.shape[0])]
                                  for x in tree_leaves(carry)])


# envs whose simulators run on the host: they train through
# runner/host_runner.py and runner/host_separated_runner.py
HOST_ENVS = ("StarCraft2", "SMAC", "StarCraft2v2", "SMACv2", "Football")


class BaseRunner:
    def __init__(self, cfg, vec_env=None, eval_env=None):
        cfg = cfg.validate()
        if cfg.env_name in HOST_ENVS:
            raise ValueError(
                f"{cfg.env_name} runs on the host runners "
                "(runner/host_runner.py, runner/host_separated_runner.py) "
                "through scripts/train_smac.py or scripts/train_football.py")
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.mesh = mesh_lib.make_mesh(cfg.mesh_shape, self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        # the action draws: this rank's rows of the global draw
        self.draws = self.generator if self.mesh is None else \
            distributed.RowDraws(self.generator, self.mesh)
        self.init_generator = torch.Generator().manual_seed(cfg.seed)
        self.envs = vec_env if vec_env is not None else make_vec_env(
            cfg, self.device, self.generator, mesh=self.mesh)
        self.eval_envs = eval_env
        self.num_agents = self.envs.num_agents
        self.N = self.envs.n_envs                  # this rank's envs
        self.N_global = self.N * (self.mesh.size if self.mesh else 1)
        self.episodes = (int(cfg.num_env_steps) // cfg.episode_length
                         // self.N_global)
        self.start_episode = 0

    def _generators(self) -> dict:
        return {"device": self.generator, "init": self.init_generator}

    def _state(self, state, method):
        """`state` through each trainer's `StateShards.<method>`: "cut",
        "gathered" or "full" (`parallel/mesh.py`)."""
        algos = getattr(self, "algos", None) or [self.algo]
        return mesh_lib.each_state([a.shards for a in algos], state, method)

    def _restore(self, state, carry):
        """With cfg.model_dir: the state, carry, generators and episode
        counter from its checkpoint."""
        self.start_episode = 0
        if not self.cfg.model_dir:
            return state, carry
        state, step, saved = ckpt_lib.restore(
            self.cfg.model_dir, state, self.device, self._generators(),
            lambda s: self._state(s, "cut"))
        self.start_episode = step
        if saved is not None:
            saved = local_carry(saved, self.mesh)
            carry = {**saved,
                     "env_states": WorldState.from_tensors(saved["env_states"])}
        return state, carry

    def _save(self, save_dir, state, carry, step):
        """The checkpoint, with the whole state and the global carry;
        written where `save_dir` is given (rank 0), gathered on every
        rank."""
        state = self._state(state, "full")
        flat_carry = {**carry, "env_states": carry["env_states"].tensors()}
        flat_carry = gather_carry(flat_carry, self.mesh)
        if save_dir:
            ckpt_lib.save(save_dir, state, step, self._generators(),
                          flat_carry)

    def _gather_episode(self, traj: dict, last: dict):
        """This rank's staged steps [T, N, ...] and last slot [N, ...] →
        the whole episode's, every rank's envs in rank order (one
        collective: the device span `rollout.gather`)."""
        if self.mesh is None:
            return traj, last
        both = {**{("t", k): v for k, v in traj.items()},
                **{("l", k): v[None] for k, v in last.items()}}
        with profiling.span("rollout.gather", device=True):
            out = distributed.gather_rows(both, 1, self.mesh)
        return ({k: out["t", k] for k in traj},
                {k: out["l", k][0] for k in last})

    # ---- host training loop ------------------------------------------
    def run(self, log_fn=print, save_dir=None):
        """Train to num_env_steps. Over a mesh, give `log_fn` and
        `save_dir` to rank 0 only: the others log nothing and take part in
        the checkpoints' gathers."""
        cfg = self.cfg
        state, carry = self.init()
        start_episode = self.start_episode
        start = time.perf_counter()
        history = []
        E = max(cfg.episodes_per_call, 1)
        steps = cfg.episode_length * self.N_global
        saves = distributed.any_rank(save_dir is not None, self.mesh)
        evals = cfg.use_eval and distributed.any_rank(
            self.eval_envs is not None, self.mesh)
        writer = self.mesh is None or self.mesh.rank == 0
        for episode in range(start_episode, self.episodes, E):
            trace_now = (cfg.profile_dir is not None and writer
                         and 2 <= episode < 2 + E)
            with profiling.trace(cfg.profile_dir, trace_now, self.device):
                chained = []
                for _ in range(E):
                    state, carry, metrics = self.episode(state, carry)
                    chained.append(metrics)
            metrics = chained[0] if E == 1 else {
                k: torch.stack([m[k] for m in chained]).mean()
                for k in chained[0]}
            end = min(episode + E, self.episodes)
            eval_row = None
            if evals and episode % cfg.eval_interval < E:
                acting = self._state(state, "gathered")
                if self.eval_envs is not None:
                    eval_row = float(self.eval_episode(acting))
            if episode % cfg.log_interval < E or episode + E >= self.episodes:
                fps = (end - start_episode) * steps / (time.perf_counter() - start)
                row = {"episode": episode, "steps": end * steps, "fps": fps,
                       **{k: float(v) for k, v in metrics.items()}}
                if eval_row is not None:
                    row["eval_average_episode_rewards"] = eval_row
                history.append(row)
                if log_fn is print:
                    losses = "".join(
                        f" {short} {row[k]:.3f}" for k, short in
                        (("value_loss", "vloss"), ("policy_loss", "ploss"))
                        if k in row)
                    print(f"ep {episode} steps {row['steps']} fps {fps:,.0f} "
                          f"rew {row['average_episode_rewards']:.2f}{losses}")
                elif log_fn is not None:
                    log_fn(row)
            elif eval_row is not None:
                row = {"episode": episode,
                       "eval_average_episode_rewards": eval_row}
                history.append(row)
                if log_fn not in (print, None):
                    log_fn(row)
            if saves and (episode % max(cfg.save_interval, 1) < E
                          or episode + E >= self.episodes):
                self._save(save_dir, state, carry, end)
        return state, history
