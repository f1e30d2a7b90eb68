"""Driver of the Hanabi runner: one training iteration is
`HanabiRunner.episode(..., do_train=True)`: the episode's first seat
round, the deferred update on the previous episode's buffer, then the
T-1 other rounds. The first episode of a run only collects."""
from __future__ import annotations

import types

import torch

from portbench import program
from portbench.drivers.mpe_shared import launch_counters
from portbench.reference import ppo
from portbench.reference.side import STEPS

# the buffer fields the reference reads
FIELDS = ("obs", "share_obs", "actions", "action_log_probs", "value_preds",
          "rewards", "masks", "active_masks", "available_actions",
          "rnn_states", "rnn_states_critic")
# the fields of the next episode's first slot that patch a buffer's tail
PATCH = ("obs", "share_obs", "available_actions", "active_masks", "rewards")


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from onpolicy_torch.runner.hanabi_runner import HanabiRunner
        from onpolicy_torch.scripts import train_hanabi
        cfg = train_hanabi.config_from_args(
            config["flags"] + traffic["flags"]
            + ["--seed", str(seed), "--device", device])
        program.check_config(cfg, config)
        self.cfg = cfg
        self.runner = HanabiRunner(cfg)
        self.state, self.carry, self.dbuf = self.runner.init()
        envs = self.runner.envs
        hp = {**config["model"], **config["ppo"]}
        g = torch.Generator(device=device).manual_seed(seed)
        self.weights = {
            "actor": ppo.make_params(ppo.net_shapes(
                hp, envs.obs_dim, envs.n_moves, "actor"), g, device),
            "critic": ppo.make_params(ppo.net_shapes(
                hp, envs.share_dim, 1, "critic"), g, device)}
        with torch.no_grad():
            program.load_weights(self.state.actor_params,
                                 self.weights["actor"])
            program.load_weights(self.state.critic_params,
                                 self.weights["critic"])
        self.steps_per_iteration = cfg.episode_length * cfg.n_rollout_threads
        self.rows_per_iteration = self.steps_per_iteration * cfg.num_agents
        self.collected = False

    def iterate(self, phase=None):
        """One episode: trains on the previous one's buffer unless it is
        the run's first; -> its metrics."""
        timer = None if phase is None else types.SimpleNamespace(phase=phase)
        self.state, self.carry, self.dbuf, m = self.runner.episode(
            self.state, self.carry, self.dbuf, do_train=self.collected,
            timer=timer)
        self.collected = True
        return m

    def checked_iterations(self, n: int) -> dict:
        """The collecting episode and n trained ones, through `iterate`,
        with what the reference needs (on the host): each collected
        buffer (the first from the run's fresh deal) and the first
        update's first Adam steps (`program.watch_steps`)."""
        h = program.host
        cap = {"weights": {net: {k: h(v) for k, v in w.items()}
                           for net, w in self.weights.items()},
               "buffers": []}
        cap["steps"], stop = program.watch_steps(self.runner.algo, STEPS)
        for i in range(n + 1):
            self.iterate()
            if i == 1:
                stop()
            if i < n:
                cap["buffers"].append({k: h(self.dbuf[k]) for k in FIELDS})
            else:
                cap["patch_last"] = {k: h(self.dbuf[k][0]) for k in PATCH}
        return cap

    def dims(self) -> dict:
        envs, cfg = self.runner.envs, self.cfg
        rows = self.rows_per_iteration
        L = cfg.data_chunk_length
        return {"obs_dim": envs.obs_dim, "share_dim": envs.share_dim,
                "n_actions": envs.n_moves, "actor_rows": rows,
                "critic_rows": rows + cfg.n_rollout_threads * cfg.num_agents,
                "train_rows": rows // L * L}

    def launch_counters(self) -> dict:
        return launch_counters()

    def close(self):
        envs = getattr(self.runner, "envs", None)
        if envs is not None and hasattr(envs, "close"):
            envs.close()
        self.runner = self.state = self.carry = self.dbuf = None
