"""What the shared and the separated runner have in common.

The set-up (config, device, generators, the env and the eval env), the
refusal of what is not ported yet, checkpoints, and the host training
loop `run` of the JAX package's `runner/shared_runner.py:262-333`:
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
"""
from __future__ import annotations

import time

import numpy as np
import torch

from onpolicy_torch.envs.mpe import make_vec_env
from onpolicy_torch.envs.mpe.world import WorldState
from onpolicy_torch.utils import checkpoint as ckpt_lib
from onpolicy_torch.utils import profiling


def refuse_unported(cfg):
    """Raise NotImplementedError for options whose port is still to come."""
    if int(np.prod(cfg.mesh_shape)) > 1:
        raise NotImplementedError("not ported yet: multi-device mesh_shape "
                                  "(ROADMAP.md, Slice G)")


# envs whose simulators run on the host: they train through
# runner/host_runner.py and runner/host_separated_runner.py
HOST_ENVS = ("StarCraft2", "SMAC", "StarCraft2v2", "SMACv2", "Football")


class BaseRunner:
    def __init__(self, cfg, vec_env=None, eval_env=None):
        cfg = cfg.validate()
        refuse_unported(cfg)
        if cfg.env_name in HOST_ENVS:
            raise ValueError(
                f"{cfg.env_name} runs on the host runners "
                "(runner/host_runner.py, runner/host_separated_runner.py) "
                "through scripts/train_smac.py or scripts/train_football.py")
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.init_generator = torch.Generator().manual_seed(cfg.seed)
        self.envs = vec_env if vec_env is not None else make_vec_env(
            cfg, self.device, self.generator)
        self.eval_envs = eval_env
        self.num_agents = self.envs.num_agents
        self.N = self.envs.n_envs
        self.episodes = int(cfg.num_env_steps) // cfg.episode_length // self.N
        self.start_episode = 0

    def _generators(self) -> dict:
        return {"device": self.generator, "init": self.init_generator}

    def _restore(self, state, carry):
        """With cfg.model_dir: the state, carry, generators and episode
        counter from its checkpoint."""
        self.start_episode = 0
        if not self.cfg.model_dir:
            return state, carry
        state, step, saved = ckpt_lib.restore(
            self.cfg.model_dir, state, self.device, self._generators())
        self.start_episode = step
        if saved is not None:
            carry = {**saved,
                     "env_states": WorldState.from_tensors(saved["env_states"])}
        return state, carry

    def _save(self, save_dir, state, carry, step):
        flat_carry = {**carry, "env_states": carry["env_states"].tensors()}
        ckpt_lib.save(save_dir, state, step, self._generators(), flat_carry)

    # ---- host training loop ------------------------------------------
    def run(self, log_fn=print, save_dir=None):
        cfg = self.cfg
        state, carry = self.init()
        start_episode = self.start_episode
        start = time.perf_counter()
        history = []
        E = max(cfg.episodes_per_call, 1)
        steps = cfg.episode_length * self.N
        for episode in range(start_episode, self.episodes, E):
            trace_now = cfg.profile_dir is not None and 2 <= episode < 2 + E
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
            if self.eval_envs is not None and cfg.use_eval \
                    and episode % cfg.eval_interval < E:
                eval_row = float(self.eval_episode(state))
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
            if save_dir and (episode % max(cfg.save_interval, 1) < E
                             or episode + E >= self.episodes):
                self._save(save_dir, state, carry, end)
        return state, history
