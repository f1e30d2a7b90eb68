"""Turn-based Hanabi runner (shared policy).

Port of `onpolicy_tpu/runner/hanabi_runner.py` (the reference's
`runner/shared/hanabi_runner_forward.py`). One buffer step is one full
seat round: per seat, only the games with available actions act (the
others no-op with −1); rewards accrue to a seat from the moment it acts
until its next action; games finishing mid-round blank the remaining
seats' staging and are reset after the round. Buffer writes use
choose-insert slotting (obs at t, masks at t+1), and TRAINING IS DEFERRED
one buffer step: at step 0 of the next episode the previous episode's
tail slot is patched with the fresh round, rewards shift one step, and
GAE + PPO run.

The actor runs per seat on the whole [N] fleet (the trainer's `act`: its
action feeds the next seat's observation; rows that do not act are
discarded), and the critic once per round on the staged [N·M] rows (its
`get_values`). Policy, staging, buffer and update live on the run's
device. Two round loops over two engines:
  * the host seat loop `_host_round` (no collect flag, as JAX's default):
    the engine's numpy protocol, one copy of the actions to the host and
    one of the observations back a seat, the masked reset after the
    round; on the C++ engine (`envs/hanabi/hanabi_env.HanabiVecEnv`, the
    reference's data path) or the tensor engine's fleet (`--use_jax_env`);
  * the device round `_device_round` (`--use_device_collect` or
    `--use_scan_rounds`): the fleet's pure API, the masked reset inside
    the round; on the tensor engine (`envs/hanabi/torch_fleet.py`), where
    nothing inside a round leaves the device, or on the C++ engine through
    `torch_fleet.CppHanabiFleet`.
Both stage through the same code and give the same numbers. `run` reads
the episode's scalars once an episode. `det_collect` makes collection
take each policy's mode (the tests' lockstep with the JAX package), and
on the tensor engine the round and the episode take the decks of the
games they reset, for the same reason. `utils.profiling` spans mark the
rounds' layers (`rollout.act`, `rollout.env`, `rollout.store`, and on
the host seat loop `rollout.copy`, each copy counted in `host_copies`)
and the deferred update's returns (`update.returns`).
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from onpolicy_torch import buffer as buf_lib
from onpolicy_torch.algorithms.mappo import MAPPO
from onpolicy_torch.envs.hanabi import torch_engine as te
from onpolicy_torch.envs.hanabi.hanabi_env import HanabiVecEnv
from onpolicy_torch.envs.hanabi.torch_fleet import (CppHanabiFleet,
                                                    TorchHanabiFleet, upload)
from onpolicy_torch.parallel import mesh as mesh_lib
from onpolicy_torch.utils import checkpoint as ckpt_lib
from onpolicy_torch.utils import profiling


def _no_phase(name):
    return contextlib.nullcontext()


def _upload(device, *arrays):
    """`torch_fleet.upload` as one of the rollout's host copies."""
    with profiling.span("rollout.copy"):
        profiling.count("host_copies")
        return upload(device, *arrays)


def _put_seat(x, seat, new, when):
    """x with x[:, seat] replaced by `new` where `when` (a new tensor)."""
    out = x.clone()
    out[:, seat] = torch.where(when, new, x[:, seat])
    return out


class HanabiRunner:
    def __init__(self, cfg, vec_env=None, eval_env=None):
        """`vec_env`: the training fleet (default: the C++ engine's
        `HanabiVecEnv`, or the tensor engine's fleet under
        `--use_jax_env`); `eval_env`: the fleet of `--use_eval`'s
        evaluation (numpy protocol), None for none."""
        cfg = cfg.validate()
        if int(np.prod(mesh_lib.check_shape(cfg.mesh_shape))) > 1:
            # JAX's runner/hanabi_runner.py never reads mesh_shape: it has
            # no data-parallel path for the port to carry
            raise ValueError(
                "the Hanabi runner trains on one device: the JAX package's "
                "Hanabi runner has no mesh path (ROADMAP.md, Queue 3)")
        if cfg.episodes_per_call != 1 or cfg.profile_dir:
            # the JAX package's Hanabi runner takes neither; refused here
            # rather than ignored
            raise ValueError(
                "the Hanabi runner runs one episode a call and takes no "
                "--profile_dir; profile it with scripts/profile_episode.py "
                "--config hanabi_device")
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self.init_generator = torch.Generator().manual_seed(cfg.seed)
        self.host_loop = not (cfg.use_device_collect or cfg.use_scan_rounds)
        if vec_env is None:
            name = (cfg.scenario_name if cfg.scenario_name.startswith("Hanabi")
                    else "Hanabi-Small")
            if cfg.use_jax_env:
                vec_env = TorchHanabiFleet(
                    name, cfg.num_agents, cfg.n_rollout_threads, self.device,
                    self.generator,
                    use_obs_instead_of_state=cfg.use_obs_instead_of_state)
            else:
                vec_env = HanabiVecEnv(
                    name, cfg.num_agents, cfg.n_rollout_threads, seed=cfg.seed,
                    use_obs_instead_of_state=cfg.use_obs_instead_of_state)
        # every fleet speaks both the numpy protocol and the pure API
        self.envs = (vec_env if hasattr(vec_env, "pure_step")
                     else CppHanabiFleet(vec_env, self.device))
        self.eval_envs = eval_env
        self.num_agents = self.envs.num_agents
        self.N = self.envs.n_envs
        obs_space = self.envs.observation_space[0]
        share_space = (self.envs.share_observation_space[0]
                       if cfg.use_centralized_V else obs_space)
        self.episodes = int(cfg.num_env_steps) // cfg.episode_length // self.N
        self.algo = MAPPO(cfg, obs_space, share_space,
                          self.envs.action_space[0],
                          total_updates=self.episodes)
        self.det_collect = False
        self.true_total_num_steps = 0

    def _generators(self) -> dict:
        return {"device": self.generator, "init": self.init_generator}

    # ---- state ---------------------------------------------------------
    def _alloc_buffer(self) -> dict:
        cfg, N, M, T = self.cfg, self.N, self.num_agents, self.cfg.episode_length
        Do = self.envs.obs_dim
        Ds = self.envs.share_dim if cfg.use_centralized_V else Do
        A = self.envs.n_moves
        L, H = cfg.recurrent_N, cfg.hidden_size
        z = lambda *s: torch.zeros(s, device=self.device)
        one = lambda *s: torch.ones(s, device=self.device)
        return {
            "share_obs": z(T + 1, N, M, Ds), "obs": z(T + 1, N, M, Do),
            "rnn_states": z(T + 1, N, M, L, H),
            "rnn_states_critic": z(T + 1, N, M, L, H),
            "actions": z(T, N, M, 1), "action_log_probs": z(T, N, M, 1),
            "value_preds": z(T + 1, N, M, 1), "rewards": z(T, N, M, 1),
            "masks": one(T + 1, N, M, 1), "bad_masks": one(T + 1, N, M, 1),
            "active_masks": one(T + 1, N, M, 1),
            "available_actions": one(T + 1, N, M, A),
        }

    def _fresh_staging(self, obs, share, avail, env_states=None) -> dict:
        """The round carry for a fresh fleet from its observation (tensors
        on the device): the next seat's inputs (use_*), the per-seat
        staging [N, M, ...] and the engine state of the device round."""
        N, M = self.N, self.num_agents
        L, H = self.cfg.recurrent_N, self.cfg.hidden_size
        if not self.cfg.use_centralized_V:
            share = obs
        z = lambda *s: torch.zeros(s, device=self.device)
        return {
            "use_obs": obs, "use_share": share, "use_avail": avail,
            "obs": z(N, M, obs.shape[-1]), "share_obs": z(N, M, share.shape[-1]),
            "avail": z(N, M, avail.shape[-1]), "values": z(N, M, 1),
            "actions": z(N, M, 1), "logp": z(N, M, 1),
            "rnn": z(N, M, L, H), "rnn_critic": z(N, M, L, H),
            "masks": torch.ones(N, M, 1, device=self.device),
            "active": torch.ones(N, M, 1, device=self.device),
            "rewards": z(N, M, 1), "accum": z(N, M, 1),
            "env_states": env_states,
        }

    def init(self, decks: Optional[torch.Tensor] = None):
        """→ (train_state, carry, buffer) of a fresh run, the whole fleet
        reset; `decks` [N, deck_len] deal the device round's first games on
        the tensor engine instead of the fleet's draw."""
        if self.host_loop:
            if decks is not None:
                raise ValueError("the host seat loop takes no decks")
            obs, share, avail, _ = upload(self.device, *self.envs.reset())
            carry = self._fresh_staging(obs, share, avail)
        else:
            states = self.envs.reset_states(decks)
            carry = self._fresh_staging(*self.envs.observe(states)[:3],
                                        env_states=states)
        train_state = self.algo.init_state(self.init_generator, self.device)
        return train_state, carry, self._alloc_buffer()

    # ---- one seat round --------------------------------------------------
    def _act(self, train_state, c: dict, seat: int):
        """The actor on the whole fleet for `seat` → (actions, logp, rnn)."""
        return self.algo.act(
            train_state, c["use_obs"], c["rnn"][:, seat],
            c["masks"][:, seat], self.generator, c["use_avail"],
            deterministic=self.det_collect)

    @staticmethod
    def _stage_choice(c: dict, seat: int, choose, actions, logp, rnn):
        """The chosen games' inputs and outputs of `seat` into the staging."""
        c1, c2 = choose[:, None], choose[:, None, None]
        for name, new, when in (("obs", c["use_obs"], c1),
                                ("share_obs", c["use_share"], c1),
                                ("avail", c["use_avail"], c1),
                                ("actions", actions, c1),
                                ("logp", logp, c1), ("rnn", rnn, c2)):
            c[name] = _put_seat(c[name], seat, new, when)

    @staticmethod
    def _stage_outcome(c: dict, seat: int, choose, rewards, done):
        """After the step of `seat`: reward accrual since each seat's last
        action; the games that ended (`done & choose`, returned) blank
        their future seats and their recurrent states; the others keep
        their masks."""
        c1, c2 = choose[:, None], choose[:, None, None]
        c["rewards"] = _put_seat(c["rewards"], seat, c["accum"][:, seat], c1)
        c["accum"] = _put_seat(c["accum"], seat, 0.0, c1)
        c["accum"] = c["accum"] + torch.where(c2, rewards, 0.0)

        nd = done & choose
        nd1, nd2 = nd[:, None], nd[:, None, None]
        c["use_avail"] = torch.where(nd1, 0.0, c["use_avail"])
        c["masks"] = torch.where(nd2, 0.0, c["masks"])
        c["rnn"] = torch.where(nd[:, None, None, None], 0.0, c["rnn"])
        c["active"] = _put_seat(c["active"], seat, 1.0, nd1)
        M = c["active"].shape[1]
        if seat + 1 < M:
            def blank(name, new):
                out = c[name].clone()
                out[:, seat + 1:] = torch.where(nd2, new, c[name][:, seat + 1:])
                c[name] = out
            blank("active", 0.0)
            blank("rewards", c["accum"][:, seat + 1:])
            blank("accum", 0.0)
            blank("obs", 0.0)
            blank("share_obs", 0.0)
        alive = ((~done) & choose)[:, None]
        c["masks"] = _put_seat(c["masks"], seat, 1.0, alive)
        c["active"] = _put_seat(c["active"], seat, 1.0, alive)
        return nd

    def _deferred_critic(self, train_state, c: dict, rnn_c0, masks0, chose,
                         zeroed, done_this_round):
        """One [N·M] critic pass over the staged share_obs from the
        round-start states and masks: the chosen slots take the fresh value
        and state, the future seats blanked at a game's end (`zeroed`)
        value 0, the games that ended zero critic states, the rest keep
        their staging."""
        v_all, rnn_c_all = self.algo.get_values(
            train_state, c["share_obs"], rnn_c0, masks0)
        c["values"] = torch.where(
            zeroed[..., None], 0.0,
            torch.where(chose[..., None], v_all, c["values"]))
        c["rnn_critic"] = torch.where(
            done_this_round[:, None, None, None], 0.0,
            torch.where(chose[:, :, None, None], rnn_c_all, c["rnn_critic"]))

    @torch.no_grad()
    def _device_round(self, train_state, carry: dict,
                      decks: Optional[torch.Tensor] = None):
        """One full seat round through the fleet's pure API, then the
        deferred critic and the masked reset of the games that ended (from
        `decks` if given). Returns (carry, aux) with aux: reset_choose [N],
        masks_insert (the masks before the reset, which the buffer slots at
        t+1), score_sum, score_n and true_delta (0-dim tensors)."""
        cfg, N, M = self.cfg, self.N, self.num_agents
        dev = self.device
        c = dict(carry)
        reset_choose = torch.zeros(N, dtype=torch.bool, device=dev)
        done_this_round = torch.zeros(N, dtype=torch.bool, device=dev)
        score_sum = torch.zeros((), device=dev)
        score_n = torch.zeros((), dtype=torch.int32, device=dev)
        true_delta = torch.zeros((), dtype=torch.int32, device=dev)
        chose_l, zero_l = [], []
        # round-start critic state and masks, for the deferred critic
        rnn_c0, masks0 = c["rnn_critic"], c["masks"]

        for seat in range(M):
            choose = (c["use_avail"] == 1).any(1)                   # [N]
            with profiling.span("rollout.act"):
                actions, logp, rnn = self._act(train_state, c, seat)
            chose_l.append(choose)
            zero_l.append(done_this_round)
            with profiling.span("rollout.store"):
                self._stage_choice(c, seat, choose, actions, logp, rnn)

            with profiling.span("rollout.env"):
                env_actions = torch.where(choose, actions[:, 0].long(), -1)
                (c["env_states"], obs, share, rewards, done, avail,
                 score) = self.envs.pure_step(c["env_states"], env_actions)
            if not cfg.use_centralized_V:
                share = obs
            true_delta = true_delta + choose.sum(dtype=torch.int32)
            c["use_obs"], c["use_share"], c["use_avail"] = obs, share, avail

            with profiling.span("rollout.store"):
                nd = self._stage_outcome(c, seat, choose, rewards, done)
            reset_choose = reset_choose | nd
            done_this_round = done_this_round | nd
            score_sum = score_sum + torch.where(nd, score.float(), 0.0).sum()
            score_n = score_n + nd.sum(dtype=torch.int32)

        with profiling.span("rollout.act"):
            self._deferred_critic(train_state, c, rnn_c0, masks0,
                                  torch.stack(chose_l, 1),
                                  torch.stack(zero_l, 1), done_this_round)

        masks_insert = c["masks"]
        with profiling.span("rollout.env"):
            (c["env_states"], fresh_obs, fresh_share, fresh_avail, _, _,
             _) = self.envs.reset_observe(c["env_states"], reset_choose, decks)
        if not cfg.use_centralized_V:
            fresh_share = fresh_obs
        rc1 = reset_choose[:, None]
        c["use_obs"] = torch.where(rc1, fresh_obs, c["use_obs"])
        c["use_share"] = torch.where(rc1, fresh_share, c["use_share"])
        c["use_avail"] = torch.where(rc1, fresh_avail, c["use_avail"])
        c["masks"] = torch.where(reset_choose[:, None, None], 1.0, c["masks"])
        aux = {"reset_choose": reset_choose, "masks_insert": masks_insert,
               "score_sum": score_sum, "score_n": score_n,
               "true_delta": true_delta}
        return c, aux

    @torch.no_grad()
    def _host_round(self, train_state, carry: dict):
        """One full seat round through the fleet's numpy protocol (JAX's
        `_host_round`): per seat one copy of the actions to the engine and
        one of its outputs back. The games that end are not reset here:
        `_host_reset` does it after the buffer insert. Returns (carry, aux)
        with aux: reset_choose [N] and the finished games' scores (numpy),
        true_delta (int)."""
        cfg, N, M = self.cfg, self.N, self.num_agents
        c = dict(carry)
        reset_choose = np.zeros(N, bool)
        chose = np.zeros((N, M), bool)
        # the seat at which each game ended this round (M: it did not);
        # it blanks the future seats also where the loop breaks before it
        # visits them
        done_at = np.full(N, M)
        scores, true_delta = [], 0
        rnn_c0, masks0 = c["rnn_critic"], c["masks"]
        for seat in range(M):
            choose = (c["use_avail"] == 1).any(1)
            with profiling.span("rollout.act"):
                actions, logp, rnn = self._act(train_state, c, seat)
            # the seat's one copy to the host
            with profiling.span("rollout.copy"):
                profiling.count("host_copies")
                env_actions = torch.where(choose, actions[:, 0].long(),
                                          -1).cpu().numpy()
            choose_np = env_actions >= 0
            if not choose_np.any():      # every game ended this round
                reset_choose[:] = True
                break
            chose[:, seat] = choose_np
            with profiling.span("rollout.store"):
                self._stage_choice(c, seat, choose, actions, logp, rnn)

            with profiling.span("rollout.env"):
                obs, share, rewards, done, _, avail, score = self.envs.step(
                    env_actions)
            if not cfg.use_centralized_V:
                share = obs
            true_delta += int(choose_np.sum())
            c["use_obs"], c["use_share"], c["use_avail"], rewards_t, done_t = \
                _upload(self.device, obs, share, avail, rewards, done)
            with profiling.span("rollout.store"):
                self._stage_outcome(c, seat, choose, rewards_t, done_t > 0)

            nd = done & choose_np
            reset_choose |= nd
            done_at[nd] = seat
            scores.extend(score[nd].tolist())

        chose_t, zeroed_t, ended_t = _upload(
            self.device, chose, done_at[:, None] < np.arange(M)[None, :],
            done_at < M)
        with profiling.span("rollout.act"):
            self._deferred_critic(train_state, c, rnn_c0, masks0,
                                  chose_t > 0, zeroed_t > 0, ended_t > 0)
        return c, {"reset_choose": reset_choose, "scores": scores,
                   "true_delta": true_delta}

    def _host_reset(self, carry: dict, reset_choose: np.ndarray) -> dict:
        """The masked reset after a host round: fresh games where
        `reset_choose`, their masks back to 1."""
        if not reset_choose.any():
            return carry
        with profiling.span("rollout.env"):
            obs, share, avail, _ = self.envs.reset(reset_choose)
        if not self.cfg.use_centralized_V:
            share = obs
        obs, share, avail, rc = _upload(self.device, obs, share, avail,
                                        reset_choose)
        rc = rc > 0
        c = dict(carry)
        c["use_obs"] = torch.where(rc[:, None], obs, c["use_obs"])
        c["use_share"] = torch.where(rc[:, None], share, c["use_share"])
        c["use_avail"] = torch.where(rc[:, None], avail, c["use_avail"])
        c["masks"] = torch.where(rc[:, None, None], 1.0, c["masks"])
        return c

    # ---- one episode ---------------------------------------------------
    @staticmethod
    def _write_slot(dbuf: dict, step: int, c: dict, masks_insert):
        """Choose-insert: the round's staging into slot `step` (obs-like
        fields) and `step + 1` (rnn states, masks)."""
        dbuf["share_obs"][step] = c["share_obs"]
        dbuf["obs"][step] = c["obs"]
        dbuf["rnn_states"][step + 1] = c["rnn"]
        dbuf["rnn_states_critic"][step + 1] = c["rnn_critic"]
        dbuf["actions"][step] = c["actions"]
        dbuf["action_log_probs"][step] = c["logp"]
        dbuf["value_preds"][step] = c["values"]
        dbuf["rewards"][step] = c["rewards"]
        dbuf["masks"][step + 1] = masks_insert
        dbuf["active_masks"][step] = c["active"]
        dbuf["available_actions"][step] = c["avail"]

    def _compute_and_train(self, train_state, dbuf: dict):
        cfg = self.cfg
        buf = buf_lib.RolloutBuffer(**dbuf)
        with profiling.span("update.returns"):
            # [0]: a name for the critic's next states would keep them alive
            # through train, at its memory peak
            next_values = self.algo.get_values(
                train_state, buf.share_obs[-1], buf.rnn_states_critic[-1],
                buf.masks[-1])[0]
            buf = buf.compute_returns(
                next_values, train_state.vnorm, gamma=cfg.gamma,
                gae_lambda=cfg.gae_lambda, use_gae=cfg.use_gae,
                use_proper_time_limits=cfg.use_proper_time_limits)
        return self.algo.train(train_state, buf, self.generator)

    def _deferred_train(self, train_state, carry: dict, dbuf: dict, phase):
        """hanabi_runner_forward.py:52-67: patch the previous episode's
        tail slot with the fresh round, shift rewards one step, train.
        Returns (train_state, metrics)."""
        dbuf["share_obs"][-1] = carry["share_obs"]
        dbuf["obs"][-1] = carry["obs"]
        dbuf["available_actions"][-1] = carry["avail"]
        dbuf["active_masks"][-1] = carry["active"]
        dbuf["rewards"] = torch.cat([dbuf["rewards"][1:],
                                     carry["rewards"][None]], 0)
        with phase("update"):
            train_state, metrics = self._compute_and_train(train_state, dbuf)
        metrics["average_step_rewards"] = dbuf["rewards"].mean()
        return train_state, metrics

    def _device_episode(self, train_state, carry: dict, dbuf: dict,
                        do_train: bool,
                        decks: Optional[Sequence[torch.Tensor]] = None,
                        timer=None):
        """One episode of device rounds: the first round, then (with
        `do_train`) the deferred training on the previous episode's
        buffer, then the T−1 remaining rounds, each written into `dbuf` (in
        place). `decks[t]` deals the games that round t resets; `timer` (an
        object whose `phase(name)` is a context; None: none) marks the
        "rollout" and "update" phases. Returns (train_state, carry, dbuf, metrics): the training
        metrics and the episode's _score_sum, _score_n and _true_delta, all
        0-dim tensors on the device."""
        T = self.cfg.episode_length
        deck = lambda t: None if decks is None else decks[t]
        phase = _no_phase if timer is None else timer.phase
        with phase("rollout"):
            carry, aux = self._device_round(train_state, carry, deck(0))
        score_sum, score_n = aux["score_sum"], aux["score_n"]
        true_delta = aux["true_delta"]
        metrics = {}
        if do_train:
            train_state, metrics = self._deferred_train(train_state, carry,
                                                        dbuf, phase)
        with phase("rollout"):
            with profiling.span("rollout.store"):
                self._write_slot(dbuf, 0, carry, aux["masks_insert"])
            for step in range(1, T):
                carry, aux = self._device_round(train_state, carry, deck(step))
                with profiling.span("rollout.store"):
                    self._write_slot(dbuf, step, carry, aux["masks_insert"])
                score_sum = score_sum + aux["score_sum"]
                score_n = score_n + aux["score_n"]
                true_delta = true_delta + aux["true_delta"]
        metrics.update(_score_sum=score_sum, _score_n=score_n,
                       _true_delta=true_delta)
        return train_state, carry, dbuf, metrics

    def _host_episode(self, train_state, carry: dict, dbuf: dict,
                      do_train: bool, timer=None):
        """One episode of host rounds (JAX's host branch of `run`): each
        round, then at step 0 (with `do_train`) the deferred training, the
        choose-insert and the masked reset. As `_device_episode`, but
        _score_sum, _score_n and _true_delta are host numbers."""
        phase = _no_phase if timer is None else timer.phase
        scores, true_delta, metrics = [], 0, {}
        for step in range(self.cfg.episode_length):
            with phase("rollout"):
                carry, aux = self._host_round(train_state, carry)
            scores += aux["scores"]
            true_delta += aux["true_delta"]
            if step == 0 and do_train:
                train_state, metrics = self._deferred_train(
                    train_state, carry, dbuf, phase)
            with phase("rollout"):
                with profiling.span("rollout.store"):
                    self._write_slot(dbuf, step, carry, carry["masks"])
                carry = self._host_reset(carry, aux["reset_choose"])
        metrics.update(_score_sum=float(np.sum(scores)), _score_n=len(scores),
                       _true_delta=true_delta)
        return train_state, carry, dbuf, metrics

    def episode(self, train_state, carry: dict, dbuf: dict, do_train: bool,
                timer=None):
        """One episode of the round loop the flags choose."""
        if self.host_loop:
            return self._host_episode(train_state, carry, dbuf, do_train,
                                      timer)
        return self._device_episode(train_state, carry, dbuf, do_train,
                                    timer=timer)

    # ---- training loop -------------------------------------------------
    def run(self, log_fn=print, save_dir=None):
        """Train for cfg.num_env_steps. The first episode (and the first
        after a resume) only collects; every later one trains first on the
        one before. With cfg.model_dir: the train state, the generators,
        the episode counter and the true-step count come from its
        checkpoint, and the fleet starts fresh, as in the JAX package.
        With cfg.use_eval and an eval fleet, `evaluate` every
        cfg.eval_interval episodes. Returns (train_state, logged rows)."""
        cfg = self.cfg
        T = cfg.episode_length
        train_state, carry, dbuf = self.init()
        start_episode = 0
        if cfg.model_dir:
            train_state, start_episode, saved = ckpt_lib.restore(
                cfg.model_dir, train_state, self.device, self._generators())
            self.true_total_num_steps = int(saved["true_total_num_steps"])
        history, metrics = [], {}
        start = time.perf_counter()
        for episode in range(start_episode, self.episodes):
            train_state, carry, dbuf, m = self.episode(
                train_state, carry, dbuf, do_train=episode > start_episode)
            # the one transfer of the episode
            values = {k: v for k, v in m.items() if not torch.is_tensor(v)}
            on_device = {k: v.float() for k, v in m.items()
                         if torch.is_tensor(v)}
            if on_device:
                values.update(zip(on_device,
                                  torch.stack(list(on_device.values()))
                                  .tolist()))
            self.true_total_num_steps += int(values.pop("_true_delta"))
            if save_dir and (episode % max(cfg.save_interval, 1) == 0
                             or episode == self.episodes - 1):
                # the fleet restarts on resume; the true steps carry on
                ckpt_lib.save(save_dir, train_state, episode + 1,
                              self._generators(),
                              {"true_total_num_steps": torch.tensor(
                                  self.true_total_num_steps)})
            if cfg.use_eval and self.eval_envs is not None \
                    and episode % cfg.eval_interval == 0:
                metrics["eval_average_score"] = self.evaluate(
                    train_state, cfg.eval_episodes, env=self.eval_envs)
            if (episode % cfg.log_interval == 0 and episode > 0) \
                    or episode == self.episodes - 1:
                n_scores = int(values.pop("_score_n"))
                average_score = values.pop("_score_sum") / max(n_scores, 1)
                metrics.update(values)
                row = {"episode": episode, "steps": (episode + 1) * T * self.N,
                       "true_steps": self.true_total_num_steps,
                       "fps": (episode - start_episode + 1) * T * self.N
                       / (time.perf_counter() - start),
                       "average_score": average_score, **metrics}
                history.append(row)
                if log_fn is print:
                    print(f"ep {episode} steps {row['steps']} "
                          f"fps {row['fps']:,.0f} score {average_score:.2f}")
                elif log_fn is not None:
                    log_fn(row)
        return train_state, history

    # ---- evaluation ----------------------------------------------------
    @torch.no_grad()
    def evaluate_device(self, train_state, n_games: int,
                        generator: Optional[torch.Generator] = None,
                        max_steps: Optional[int] = None) -> float:
        """Device-resident `eval_100k` (hanabi_runner_forward.py:281-329)
        on the tensor engine (`--use_jax_env`): generations of N one-shot
        games, each policy's mode taken, run for `max_steps` seat steps
        (finished games no-op); the mean score of the first `n_games`
        finished games. Every play or discard draws from the deck, hint
        streaks are bounded by the info tokens, and a game ends one round
        after the deck empties, so the default bound 2·deck + max_info +
        players + 8 covers any game. Decks come from `generator` (default:
        seeded with cfg.seed + 5)."""
        cfg, env = self.cfg, self.envs
        if not isinstance(env, TorchHanabiFleet):
            raise ValueError("evaluate_device requires --use_jax_env (the "
                             "tensor engine's fleet)")
        g, N = env.game, env.n_envs
        if max_steps is None:
            max_steps = 2 * g.deck_len + g.max_info + g.players + 8
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(cfg.seed + 5)
        L, H = cfg.recurrent_N, cfg.hidden_size
        masks = torch.ones(N, 1, device=self.device)
        scores = []
        while len(scores) < n_games:
            states = env.reset_states(
                te.shuffled_decks(g, N, generator, self.device))
            obs, _, avail, _, _, _ = env.observe(states)
            rnn = torch.zeros(N, L, H, device=self.device)
            for _ in range(max_steps):
                choose = (avail == 1).any(1)
                actions, _, rnn_out = self.algo.act(
                    train_state, obs, rnn, masks, available_actions=avail,
                    deterministic=True)
                env_actions = torch.where(choose, actions[:, 0].long(), -1)
                states, obs, _, _, done, avail, _ = env.pure_step(
                    states, env_actions)
                rnn = torch.where(done[:, None, None], 0.0, rnn_out)
            _, _, _, _, done, scr = env.observe(states)
            scores.extend(scr[done].tolist())
        return float(np.mean(np.asarray(scores[:n_games], np.float64)))

    @torch.no_grad()
    def evaluate(self, train_state, n_games: int, env=None) -> float:
        """Deterministic evaluation through a fleet's numpy protocol (`env`,
        default the training fleet) until `n_games` games finish, or
        100,000 steps pass; → their mean score (`eval` / `eval_100k`,
        hanabi_runner_forward.py:228-329). Finished games are reset and
        their recurrent states zeroed; the policy runs on the device."""
        cfg = self.cfg
        env = env or self.envs
        N = env.n_envs
        obs, _, avail, _ = env.reset()
        rnn = torch.zeros(N, cfg.recurrent_N, cfg.hidden_size,
                          device=self.device)
        masks = torch.ones(N, 1, device=self.device)
        scores = []
        guard = 0
        while len(scores) < n_games and guard < 100000:
            guard += 1
            choose = np.any(avail == 1, axis=1)
            if not choose.any():
                obs, _, avail, _ = env.reset()
                rnn = torch.zeros_like(rnn)
                continue
            obs_t, avail_t = upload(self.device, obs, avail)
            actions, _, rnn = self.algo.act(train_state, obs_t, rnn, masks,
                                            available_actions=avail_t,
                                            deterministic=True)
            env_actions = np.full(N, -1, np.int64)
            env_actions[choose] = actions[:, 0].cpu().numpy()[choose]
            obs, _, _, done, _, avail, score = env.step(env_actions)
            newly = done & choose
            if newly.any():
                scores.extend(score[newly].tolist())
                o2, _, a2, _ = env.reset(newly)
                obs[newly] = o2[newly]
                avail[newly] = a2[newly]
                (fresh,) = upload(self.device, newly)
                rnn = torch.where(fresh[:, None, None] > 0, 0.0, rnn)
        return float(np.mean(scores[:n_games])) if scores else 0.0
