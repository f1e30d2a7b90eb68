"""Driver of the MPE shared-policy runner: one training iteration is
`SharedRunner.rollout` then `MAPPO.train`, the body of
`SharedRunner.episode` (T env steps of N worlds, then ppo_epoch PPO
updates)."""
from __future__ import annotations

import contextlib

import torch

from portbench import program
from portbench.reference import ppo
from portbench.reference.side import STEPS


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from onpolicy_torch.config import config_from_args
        from onpolicy_torch.runner.shared_runner import SharedRunner
        cfg = config_from_args(config["flags"] + traffic["flags"]
                               + ["--seed", str(seed), "--device", device])
        program.check_config(cfg, config)
        self.cfg = cfg
        self.runner = SharedRunner(cfg)
        self.state, self.carry = self.runner.init()
        envs = self.runner.envs
        hp = {**config["model"], **config["ppo"]}
        g = torch.Generator(device=device).manual_seed(seed)
        self.weights = {
            "actor": ppo.make_params(ppo.net_shapes(
                hp, envs.observation_space[0].shape[0],
                envs.action_space[0].n, "actor"), g, device),
            "critic": ppo.make_params(ppo.net_shapes(
                hp, envs.share_observation_space[0].shape[0], 1, "critic"),
                g, device)}
        with torch.no_grad():
            program.load_weights(self.state.actor_params,
                                 self.weights["actor"])
            program.load_weights(self.state.critic_params,
                                 self.weights["critic"])
        self.steps_per_iteration = cfg.episode_length * cfg.n_rollout_threads
        self.rows_per_iteration = self.steps_per_iteration * cfg.num_agents
        self.trained = 0

    def iterate(self, phase=None, keep: bool = False):
        """One training iteration; -> its metrics (0-dim tensors). With
        `keep` the rollout buffer stays in `last_buffer`."""
        phase = phase or (lambda name: contextlib.nullcontext())
        with phase("rollout"):
            self.carry, buf = self.runner.rollout(self.state, self.carry)
        with phase("update"):
            self.state, metrics = self.runner.algo.train(
                self.state, buf, self.runner.generator)
        self.trained += 1
        self.last_buffer = buf if keep else None
        return metrics

    def checked_iterations(self, n: int) -> dict:
        """The first n iterations, through `iterate`, with what the
        reference needs of each (on the host) and the first iteration's
        first Adam steps (`program.watch_steps`)."""
        h = program.host
        cap = {"weights": {net: {k: h(v) for k, v in w.items()}
                           for net, w in self.weights.items()},
               "iterations": []}
        cap["steps"], stop = program.watch_steps(self.runner.algo, STEPS)
        for i in range(n):
            self.iterate(keep=True)
            if i == 0:
                stop()
            b = self.last_buffer
            cap["iterations"].append({
                "obs": h(b.obs), "share_obs": h(b.share_obs),
                "actions": h(b.actions), "logp": h(b.action_log_probs),
                "values": h(b.value_preds), "rewards": h(b.rewards),
                "masks": h(b.masks), "active": h(b.active_masks),
                "rnn_actor": h(b.rnn_states),
                "rnn_critic": h(b.rnn_states_critic),
                "returns": h(b.returns)})
        self.last_buffer = None
        return cap

    def dims(self) -> dict:
        envs, cfg = self.runner.envs, self.cfg
        rows = self.rows_per_iteration
        L = cfg.data_chunk_length
        return {"obs_dim": envs.observation_space[0].shape[0],
                "share_dim": envs.share_observation_space[0].shape[0],
                "n_actions": envs.action_space[0].n,
                "actor_rows": rows,
                "critic_rows": rows + cfg.n_rollout_threads * cfg.num_agents,
                "train_rows": rows // L * L}

    def launch_counters(self) -> dict:
        return launch_counters()

    def close(self):
        self.runner = self.state = self.carry = self.last_buffer = None


def launch_counters() -> dict:
    """The GRU library's own launch counters (`ops/cuda_gru.py`)."""
    from onpolicy_torch.ops import cuda_gru as cg
    return {"fwd": cg.FWD_LAUNCHES, "bwd": cg.BWD_LAUNCHES,
            "fwd_steps": cg.FWD_STEP_LAUNCHES,
            **{f"wide_{k}": v for k, v in cg.WIDE_LAUNCHES.items()}}
