"""What the drivers share about the program under test: its parameter
trees as flat dicts of dotted names, loading the benchmark's weights into
them, and holding the program's resolved configuration to the
configuration file's numbers."""
from __future__ import annotations

import torch


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict / list of tensors -> {dotted path: tensor}."""
    if torch.is_tensor(tree):
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}{k}."))
    return out


def load_weights(tree, weights: dict) -> None:
    """Copy `weights` into the program's parameter tree in place; the
    names and shapes must agree one for one."""
    flat = flatten(tree)
    if set(flat) != set(weights):
        raise ValueError("parameter names differ: program has "
                         f"{sorted(set(flat) - set(weights))}, benchmark "
                         f"{sorted(set(weights) - set(flat))}")
    for name, leaf in flat.items():
        if leaf.shape != weights[name].shape:
            raise ValueError(f"{name}: program {tuple(leaf.shape)}, "
                             f"benchmark {tuple(weights[name].shape)}")
        leaf.copy_(weights[name])


def check_config(cfg, config: dict) -> None:
    """The program's resolved Config must hold every number of the
    configuration file's `model`, `ppo` and `env` sections."""
    for section in ("model", "ppo", "env"):
        for key, want in config[section].items():
            got = getattr(cfg, key)
            if got != want:
                raise ValueError(f"config {config['name']}: {key} = {got!r} "
                                 f"in the program, {want!r} in the file")


def watch_steps(algo, n: int):
    """Record the trainer's first n Adam steps as they happen: each
    step's losses, the optimizers' first moments after the first and the
    parameters after the n-th (on the host). The trainer's `_update` is
    shadowed on the instance until `stop()` is called. -> (record, stop)."""
    rec = {"losses": []}
    update = algo._update

    def watched(state, mb):
        state, aux = update(state, mb)
        k = len(rec["losses"]) + 1
        if k <= n:
            rec["losses"].append({name: float(aux[name]) for name in
                                  ("policy_loss", "value_loss",
                                   "dist_entropy")})
            trees = lambda a, c: {"actor": {key: host(v) for key, v in
                                            flatten(a).items()},
                                  "critic": {key: host(v) for key, v in
                                             flatten(c).items()}}
            if k == 1:
                rec["mu_first"] = trees(state.actor_opt_state["mu"],
                                        state.critic_opt_state["mu"])
            if k == n:
                rec["params"] = trees(state.actor_params, state.critic_params)
        return state, aux

    algo._update = watched
    return rec, lambda: delattr(algo, "_update")


def host(x):
    return None if x is None else x.detach().to("cpu", copy=True)
