"""The program's spans and counters (`onpolicy_torch/utils/profiling.py`)
on the CPU.

* Off (no profiler recording): `span` is the shared no-op context and
  nothing is logged; the switch, a private flag of
  `torch.autograd.profiler`, is pinned.
* On, under `torch.profiler`: records nest, counters add, `take` clears,
  and a span's times lie on the clock of the profiler's own events.
* The sites: a small MPE rollout and update record every `rollout.*` and
  `update.*` span they pass; a Hanabi device round records its env step;
  a C++-engine host episode records its copies and counts each one.
"""
import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from onpolicy_torch.config import config_from_args
from onpolicy_torch.runner import hanabi_runner
from onpolicy_torch.runner.hanabi_runner import HanabiRunner
from onpolicy_torch.runner.shared_runner import SharedRunner
from onpolicy_torch.utils import profiling

torch.set_num_threads(1)

MPE = ["--algorithm_name", "rmappo", "--scenario_name", "simple_spread",
       "--num_agents", "3", "--num_landmarks", "3", "--n_rollout_threads", "2",
       "--episode_length", "10", "--num_env_steps", "20", "--hidden_size",
       "8", "--ppo_epoch", "2", "--data_chunk_length", "5", "--device", "cpu"]
HANABI = ["--algorithm_name", "rmappo", "--env_name", "Hanabi",
          "--scenario_name", "Hanabi-Small", "--num_agents", "2",
          "--n_rollout_threads", "6", "--episode_length", "6",
          "--num_env_steps", "72", "--hidden_size", "16", "--ppo_epoch", "1",
          "--data_chunk_length", "3", "--device", "cpu"]


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_log():
    profiling.take()
    yield
    profiling.take()


def test_off_span_is_the_shared_noop_and_logs_nothing():
    a, b = profiling.span("x"), profiling.span("y", device=True)
    assert a is b is profiling._OFF
    with a:
        profiling.count("n", 3)
    assert profiling.take() == {"spans": [], "counters": {}}


def test_the_switch_is_the_profilers_private_flag():
    assert autograd_profiler._is_profiler_enabled is False
    with _profile():
        assert autograd_profiler._is_profiler_enabled is True
        assert profiling.span("x") is not profiling._OFF
    assert autograd_profiler._is_profiler_enabled is False
    assert profiling.span("x") is profiling._OFF


def test_spans_nest_counters_add_and_take_clears():
    with _profile():
        with profiling.span("a"):
            with profiling.span("b"):
                profiling.count("n")
            with profiling.span("c", device=True):
                with profiling.span("d"):
                    profiling.count("n", 2)
                    profiling.count("m")
        with profiling.span("e"):
            pass
    log = profiling.take()
    assert [(s.name, s.parent) for s in log["spans"]] == [
        ("a", -1), ("b", 0), ("c", 0), ("d", 2), ("e", -1)]
    assert log["counters"] == {"n": 3, "m": 1}
    for s in log["spans"]:
        assert s.t0_ns <= s.t1_ns
        assert s.device_ms is None       # no card: no events
    a, b, c, d, e = log["spans"]
    assert a.t0_ns <= b.t0_ns <= b.t1_ns <= c.t0_ns <= d.t0_ns
    assert d.t1_ns <= c.t1_ns <= a.t1_ns <= e.t0_ns
    assert profiling.take() == {"spans": [], "counters": {}}


def test_span_times_lie_on_the_profilers_clock():
    with _profile() as prof:
        with profiling.span("warm-up"):
            torch.ones(64).sum()
        for i in range(5):
            with profiling.span(f"s{i}"):
                torch.ones(1000).cumsum(0)
    spans = {s.name: s for s in profiling.take()["spans"]}
    seen = 0
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.name() in spans and \
                e.name() != "warm-up":
            s = spans[e.name()]
            assert abs(e.start_ns() - s.t0_ns) < 1_000_000, e.name()
            end = e.start_ns() + e.duration_ns()
            assert abs(end - s.t1_ns) < 1_000_000, e.name()
            seen += 1
    assert seen == 5


def _names(log):
    return {s.name for s in log["spans"]}


def test_mpe_rollout_and_update_record_their_spans():
    runner = SharedRunner(config_from_args(MPE))
    state, carry = runner.init()
    with _profile():
        carry, buf = runner.rollout(state, carry)
        runner.algo.train(state, buf, runner.generator)
    log = profiling.take()
    assert _names(log) == {
        "rollout.act", "rollout.env", "rollout.store", "rollout.returns",
        "update.minibatch", "update.forward", "update.backward",
        "update.allreduce", "update.optimizer"}
    count = lambda name: sum(s.name == name for s in log["spans"])
    assert count("rollout.act") == count("rollout.env") == 10
    assert count("update.forward") == count("update.optimizer") == 2
    assert all(s.parent == -1 for s in log["spans"])
    assert log["counters"] == {}


def test_hanabi_device_round_records_its_env_step():
    runner = HanabiRunner(config_from_args(
        HANABI + ["--use_jax_env", "--use_scan_rounds"]))
    state, carry, _ = runner.init()
    with _profile():
        runner._device_round(state, carry)
    log = profiling.take()
    names = [s.name for s in log["spans"]]
    # per seat: act, staging, env step, outcome; then the deferred critic
    # and the masked reset
    assert names == ["rollout.act", "rollout.store", "rollout.env",
                     "rollout.store"] * 2 + ["rollout.act", "rollout.env"]
    assert log["counters"] == {}


def test_cpp_host_episode_counts_every_copy(monkeypatch):
    runner = HanabiRunner(config_from_args(HANABI))
    state, carry, dbuf = runner.init()
    made = {"upload": 0, "cpu": 0}
    upload, cpu = hanabi_runner.upload, torch.Tensor.cpu

    def counted_upload(*args):
        made["upload"] += 1
        return upload(*args)

    def counted_cpu(self, *args, **kw):
        made["cpu"] += 1
        return cpu(self, *args, **kw)

    monkeypatch.setattr(hanabi_runner, "upload", counted_upload)
    monkeypatch.setattr(torch.Tensor, "cpu", counted_cpu)
    with _profile():
        runner.episode(state, carry, dbuf, do_train=False)
    monkeypatch.undo()
    log = profiling.take()
    names = [s.name for s in log["spans"]]
    copies = made["upload"] + made["cpu"]
    # per round and seat one copy of the actions out and one of the
    # engine's outputs in, then the deferred critic's masks and the reset
    assert made["cpu"] >= 6 and made["upload"] >= 6 + 1
    assert log["counters"] == {"host_copies": copies}
    assert names.count("rollout.copy") == copies
    assert {"rollout.act", "rollout.env", "rollout.store"} <= set(names)
    copy_spans = [s for s in log["spans"] if s.name == "rollout.copy"]
    assert all(s.parent == -1 for s in copy_spans)
    assert np.all([s.t0_ns <= s.t1_ns for s in copy_spans])
