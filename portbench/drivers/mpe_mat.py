"""Driver of MAT through the MPE shared-policy runner: one training
iteration is `SharedRunner.rollout` then `MAT.train`, the body of
`SharedRunner.episode` (T env steps of N worlds, each act one
autoregressive decode of the M agents; then ppo_epoch updates of the
whole transformer)."""
from __future__ import annotations

import contextlib

import torch

from portbench import program
from portbench.reference import mat
from portbench.reference.side import STEPS


def watch_steps(algo, n: int):
    """Record MAT's first n Adam steps as they happen: each step's losses,
    Adam's first moment after the first and the parameters after the
    n-th (on the host), each a flat dict of the tree's dotted names. The
    trainer's `_update` is shadowed on the instance until `stop()` is
    called. -> (record, stop)."""
    rec = {"losses": []}
    update = algo._update

    def watched(state, mb):
        state, aux = update(state, mb)
        k = len(rec["losses"]) + 1
        if k <= n:
            rec["losses"].append({name: float(aux[name]) for name in
                                  ("policy_loss", "value_loss",
                                   "dist_entropy")})
            tree = lambda t: {key: program.host(v) for key, v in
                              program.flatten(t).items()}
            if k == 1:
                rec["mu_first"] = tree(state.opt_state["mu"])
            if k == n:
                rec["params"] = tree(state.params)
        return state, aux

    algo._update = watched
    return rec, lambda: delattr(algo, "_update")


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from onpolicy_torch.config import config_from_args
        from onpolicy_torch.runner.shared_runner import SharedRunner
        cfg = config_from_args(config["flags"] + traffic["flags"]
                               + ["--seed", str(seed), "--device", device])
        program.check_config(cfg, config)
        self.cfg = cfg
        self.runner = SharedRunner(cfg)
        if not self.runner.is_mat:
            raise ValueError(f"{config['name']}: algorithm "
                             f"{cfg.algorithm_name} is not MAT")
        self.state, self.carry = self.runner.init()
        envs = self.runner.envs
        self.n_actions = envs.action_space[0].n
        hp = {**config["model"], **config["ppo"]}
        g = torch.Generator(device=device).manual_seed(seed)
        self.weights = mat.make_params(
            hp, envs.observation_space[0].shape[0], self.n_actions, g, device)
        with torch.no_grad():
            program.load_weights(self.state.params, self.weights)
        self.steps_per_iteration = cfg.episode_length * cfg.n_rollout_threads
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
        first Adam steps (`watch_steps`)."""
        h = program.host
        cap = {"weights": {k: h(v) for k, v in self.weights.items()},
               "n_actions": self.n_actions, "iterations": []}
        cap["steps"], stop = watch_steps(self.runner.algo, STEPS)
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
                "returns": h(b.returns)})
        self.last_buffer = None
        return cap

    def dims(self) -> dict:
        envs, cfg = self.runner.envs, self.cfg
        return {"obs_dim": envs.observation_space[0].shape[0],
                "n_actions": self.n_actions, "num_agents": cfg.num_agents,
                "episode_length": cfg.episode_length,
                "n_rollout_threads": cfg.n_rollout_threads}

    def launch_counters(self) -> dict:
        return {}

    def close(self):
        self.runner = self.state = self.carry = self.last_buffer = None
