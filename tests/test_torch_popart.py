"""`use_popart` in the port's trainers against the JAX package's.

From the same `TrainState` (JAX's, carried across by `utils/params.py`)
and one buffer (numpy draws: returns around 30 with spread 10, so that
the statistics move and PopArt rescales the head), each trainer's `train`
on both sides, one minibatch, 3 PPO epochs of a recurrent policy (T=10,
N=3, M=2, L=5, H=16):
  * rMAPPO: `popart.update` rescales the critic's `v_out` before each loss
    and folds the returns into `vnorm`;
  * HAPPO (with a sequential-update factor): the stats-only normalizer,
    the head left alone;
  * HATRPO (one pass of TRPO): the same stats-only normalizer, updated in
    the critic step — `_critic_step` once updated it under
    `use_valuenorm` only, which left the statistics at their start.
The trained parameters, Adam moments and statistics at rtol 1e-4 / atol
5e-5 (tests/test_torch_slice.py says why), the metrics too. Also: a
shared-runner run with PopArt saves and resumes exactly, and MAT takes
`use_popart` as JAX's does, normalizing under `use_valuenorm` only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onpolicy_tpu import buffer as j_buf
from onpolicy_tpu.algorithms.happo import HAPPO as JHAPPO
from onpolicy_tpu.algorithms.hatrpo import HATRPO as JHATRPO
from onpolicy_tpu.algorithms.mappo import MAPPO as JMAPPO
from onpolicy_tpu.algorithms.mat import MAT as JMAT
from onpolicy_tpu.config import Config as JaxConfig
from onpolicy_tpu.config import canonicalize_algorithm as j_canon
from onpolicy_tpu.utils import spaces as j_sp

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.algorithms.happo import HAPPO
from onpolicy_torch.algorithms.hatrpo import HATRPO
from onpolicy_torch.algorithms.mappo import MAPPO
from onpolicy_torch.algorithms.mat import MAT
from onpolicy_torch.config import Config, canonicalize_algorithm
from onpolicy_torch.runner.shared_runner import SharedRunner
from onpolicy_torch.utils import spaces as sp
from onpolicy_torch.utils.params import (train_state_from_jax,
                                         train_state_to_jax)
from onpolicy_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

TRAINED = dict(rtol=1e-4, atol=5e-5)
T, N, M, D, H = 10, 3, 2, 6, 16
TRAINERS = {"rmappo": (JMAPPO, MAPPO), "happo": (JHAPPO, HAPPO),
            "hatrpo": (JHATRPO, HATRPO)}


def _flags(algo, **kw):
    return dict(algorithm_name=algo, hidden_size=H, data_chunk_length=5,
                ppo_epoch=3, num_mini_batch=1, lr=7e-4, critic_lr=7e-4,
                use_popart=True, use_valuenorm=False, num_agents=M, **kw)


def _close(got, want, name, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **tol)


def _buffer(j_algo, state, rng):
    """A [T(+1), N, M] buffer of numpy draws; the old log-probs are the
    actor's own over the whole episode, so the ratios start at 1."""
    f = lambda *s, scale=1.0, shift=0.0: (
        rng.standard_normal(s) * scale + shift).astype(np.float32)
    masks = (rng.random((T + 1, N, M, 1)) > 0.1).astype(np.float32)
    fields = dict(
        share_obs=f(T + 1, N, M, 2 * D), obs=f(T + 1, N, M, D),
        rnn_states=f(T + 1, N, M, 1, H, scale=0.5),
        rnn_states_critic=f(T + 1, N, M, 1, H, scale=0.5),
        actions=rng.integers(0, 5, (T, N, M, 1)).astype(np.float32),
        action_log_probs=np.zeros((T, N, M, 1), np.float32),
        value_preds=f(T + 1, N, M, 1, scale=1.0),
        rewards=f(T, N, M, 1), masks=masks,
        bad_masks=np.ones((T + 1, N, M, 1), np.float32),
        active_masks=np.ones((T + 1, N, M, 1), np.float32),
        returns=f(T, N, M, 1, scale=10.0, shift=30.0),
        advantages=f(T, N, M, 1))
    jb = j_buf.RolloutBuffer(**{k: jnp.asarray(v) for k, v in fields.items()})
    logp = np.asarray(j_algo.evaluate_full_logp(state, jb))
    fields["action_log_probs"] = logp
    return jb.replace(action_log_probs=jnp.asarray(logp)), \
        buf_lib.RolloutBuffer(**{k: torch.tensor(v)
                                 for k, v in fields.items()})


@pytest.mark.parametrize("algo", sorted(TRAINERS))
def test_trainer_with_popart_matches_jax(algo):
    jcls, tcls = TRAINERS[algo]
    jc = j_canon(JaxConfig(**_flags(algo))).validate()
    tc = canonicalize_algorithm(Config(**_flags(algo), device="cpu"))
    spaces = (sp.Box((D,)), sp.Box((2 * D,)), sp.Discrete(5))
    j_algo = jcls(jc, j_sp.Box((D,)), j_sp.Box((2 * D,)), j_sp.Discrete(5))
    t_algo = tcls(tc, *spaces)
    assert t_algo.popart_rescales_head == (algo == "rmappo")
    j_state = jax.device_get(j_algo.init_state(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    jb, tb = _buffer(j_algo, j_state, rng)
    factor = None
    if algo != "rmappo":
        factor = np.exp(0.2 * rng.standard_normal((T, N, M, 1))).astype(
            np.float32)
    j_new, j_m = jax.jit(j_algo.train)(
        j_state, jb, jax.random.PRNGKey(2),
        None if factor is None else jnp.asarray(factor))
    j_new, j_m = jax.device_get((j_new, j_m))
    t_state = train_state_from_jax(j_state)
    assert t_state.vnorm is not None
    t_new, t_m = t_algo.train(
        t_state, tb, None, factor=None if factor is None
        else torch.tensor(factor))
    back = train_state_to_jax(t_new, j_new)
    for part in ("actor_params", "critic_params", "actor_opt_state",
                 "critic_opt_state", "vnorm"):
        got = jax.tree_util.tree_leaves(getattr(back, part))
        want = jax.tree_util.tree_leaves(getattr(j_new, part))
        assert len(got) == len(want), part
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, f"{part}[{i}]", TRAINED)
    # the statistics moved; PopArt's head moved with them
    assert float(back.vnorm.debiasing_term) > 0
    v_out = lambda s: np.asarray(s.critic_params["v_out"]["b"])
    for k, v in j_m.items():
        _close(float(t_m[k]), float(v), k, TRAINED)
    if algo == "rmappo":
        # the rescale alone (before any gradient) is what popart.update
        # gives: the trained bias sits far from the untrained zero
        assert abs(float(v_out(back)[0])) > 0.1


def test_popart_checkpoint_resume_is_exact(tmp_path):
    """rMAPPO with PopArt: two episodes in one run equal one episode, a
    save and a resumed run of one more: parameters (the rescaled head
    too), optimizer and the PopArt statistics."""
    kw = dict(algorithm_name="rmappo", scenario_name="simple_spread",
              num_agents=3, num_landmarks=3, n_rollout_threads=4,
              episode_length=25, hidden_size=16, ppo_epoch=2,
              use_popart=True, use_valuenorm=False, use_ReLU=False)
    make = lambda steps, **more: SharedRunner(canonicalize_algorithm(
        Config(**kw, num_env_steps=steps, device="cpu", **more)))
    steps = 4 * 25
    state_a, hist_a = make(2 * steps).run(log_fn=None,
                                          save_dir=tmp_path / "a")
    make(steps).run(log_fn=None, save_dir=tmp_path / "b")
    resumed = make(2 * steps, model_dir=str(tmp_path / "b"))
    state_b, hist_b = resumed.run(log_fn=None, save_dir=tmp_path / "c")
    assert resumed.start_episode == 1
    for part in ("actor_params", "critic_params", "actor_opt_state",
                 "critic_opt_state"):
        for x, y in zip(tree_leaves(getattr(state_a, part)),
                        tree_leaves(getattr(state_b, part))):
            assert torch.equal(x, y), part
    for k in ("running_mean", "running_mean_sq", "debiasing_term"):
        assert torch.equal(getattr(state_a.vnorm, k),
                           getattr(state_b.vnorm, k)), k
    assert float(state_a.vnorm.debiasing_term) > 0
    assert hist_a[-1] == {**hist_b[-1], "fps": hist_a[-1]["fps"]}


def test_mat_takes_popart_as_jax_does():
    """JAX's MAT has no PopArt branch: under `use_popart` (and
    `use_valuenorm` false) neither side keeps a normalizer."""
    kw = dict(algorithm_name="mat", n_embd=16, use_popart=True,
              use_valuenorm=False, num_agents=M)
    j_algo = JMAT(j_canon(JaxConfig(**kw)), j_sp.Box((D,)),
                  j_sp.Box((2 * D,)), j_sp.Discrete(5))
    t_algo = MAT(canonicalize_algorithm(Config(**kw, device="cpu")),
                 sp.Box((D,)), sp.Box((2 * D,)), sp.Discrete(5))
    assert j_algo.init_state(jax.random.PRNGKey(0)).vnorm is None
    assert t_algo.init_state(torch.Generator().manual_seed(0),
                             "cpu").vnorm is None


@pytest.mark.parametrize("config,extra", [
    ("flagship", ("--use_popart", "--use_valuenorm", "false")),
    ("world_comm", ())])
def test_train_mpe_runs_this_slices_configs(config, extra, tmp_path,
                                            monkeypatch):
    """The two configurations this slice adds to the card's runs, tiny:
    the flagship with PopArt and `CONFIGS["world_comm"]` (6 agents through
    the separated runner), with an eval each episode."""
    from onpolicy_torch.scripts import train_mpe
    monkeypatch.setenv("ONPOLICY_TORCH_RESULTS", str(tmp_path))
    argv = train_mpe.CONFIGS[config] + list(extra) + [
        "--n_rollout_threads", "4", "--num_env_steps", str(2 * 4 * 25),
        "--ppo_epoch", "1", "--hidden_size", "16", "--log_interval", "1",
        "--use_eval", "--eval_interval", "1", "--n_eval_rollout_threads", "2",
        "--device", "cpu"]
    state, history = train_mpe.main(argv)
    assert [r["episode"] for r in history] == [0, 1]
    for row in history:
        assert all(np.isfinite(v) for v in row.values()
                   if isinstance(v, float)), row
        assert "eval_average_episode_rewards" in row
    if config == "world_comm":
        assert len(state) == 6 and "agent5/value_loss" in history[-1]
    else:
        assert float(state.vnorm.debiasing_term) > 0
