"""The program's spans and counters (`onpolicy_torch/utils/profiling.py`)
on the CPU.

* Off (no profiler recording): `span` is the shared no-op context and
  nothing is logged; the switch, a private flag of
  `torch.autograd.profiler`, is pinned.
* On, under `torch.profiler`: records nest, counters add, `take` clears,
  and a span's times lie on the clock of the profiler's own events.
* The sites: a small MPE rollout and update record every `rollout.*` and
  `update.*` span they pass, under MAT too, whose decode records
  `act.decode` and counts its decoder passes; two gloo ranks record the
  episode's gather and the gradients' all-reduce; a Hanabi device round
  records its env step; a C++-engine host episode records its copies and
  counts each one.
"""
import multiprocessing as mp
import queue

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


MAT = ["--algorithm_name", "mat", "--scenario_name", "simple_spread",
       "--num_agents", "3", "--num_landmarks", "3", "--n_rollout_threads", "2",
       "--episode_length", "10", "--num_env_steps", "20", "--n_embd", "8",
       "--ppo_epoch", "2", "--num_mini_batch", "2", "--device", "cpu"]


def test_mat_rollout_and_update_record_their_spans_and_decoder_passes():
    runner = SharedRunner(config_from_args(MAT))
    state, carry = runner.init()
    carry, buf = runner.rollout(state, carry)
    runner.algo.train(state, buf, runner.generator)
    assert profiling.take() == {"spans": [], "counters": {}}
    with _profile():
        carry, buf = runner.rollout(state, carry)
        runner.algo.train(state, buf, runner.generator)
    log = profiling.take()
    assert _names(log) == {
        "rollout.act", "act.decode", "rollout.env", "rollout.store",
        "rollout.returns", "update.minibatch", "update.forward",
        "update.backward", "update.allreduce", "update.optimizer"}
    spans = log["spans"]
    count = lambda name: sum(s.name == name for s in spans)
    assert count("act.decode") == count("rollout.act") == 10
    assert all(spans[s.parent].name == "rollout.act"
               for s in spans if s.name == "act.decode")
    # 2 epochs x 2 minibatches; the advantages, then each epoch's draw
    assert count("update.forward") == count("update.optimizer") == 4
    assert count("update.minibatch") == 1 + 2
    # T x M autoregressive passes, one teacher-forced pass an update
    assert log["counters"] == {"mat_decode_passes": 10 * 3 + 2 * 2}


def _traced_rank(rank, store, out):
    """One of two gloo ranks: a traced MPE rollout and update over the
    (2,) mesh -> (rank, its spans' names and parents' names)."""
    from onpolicy_torch.parallel import distributed
    torch.set_num_threads(1)
    distributed.initialize(rank, 2, rank, 2, "gloo", "cpu",
                           store=torch.distributed.FileStore(store, 2))
    runner = SharedRunner(config_from_args(MPE + ["--mesh_shape", "2"]))
    state, carry = runner.init()
    with _profile():
        carry, buf = runner.rollout(state, carry)
        runner.algo.train(state, buf, runner.generator)
    spans = profiling.take()["spans"]
    distributed.shutdown()
    out.put((rank, [(s.name, spans[s.parent].name if s.parent >= 0
                     else None) for s in spans]))


def test_two_ranks_record_the_gather_and_the_allreduce(tmp_path):
    spawn = mp.get_context("spawn")
    out = spawn.Queue()
    procs = [spawn.Process(target=_traced_rank, daemon=True,
                           args=(r, str(tmp_path / "store"), out))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(out.get(timeout=240) for _ in procs)
    except queue.Empty:
        got = {}
    for p in procs:
        p.join(30)
        if p.is_alive():
            p.kill()
    assert set(got) == {0, 1}
    for spans in got.values():
        assert spans.count(("rollout.gather", "rollout.store")) == 1
        assert spans.count(("update.allreduce", None)) == 2


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
