"""A data-parallel job as torchrun starts one: one process a card, the
cards' processes joined in one NCCL process group, each running the
whole run (`measure`) on its card.

Rank r is a spawned process on `cuda:<r>` that joins the group through
`onpolicy_torch.parallel.distributed.initialize` (rendezvous on a free
port of localhost), then calls `measure` there. Rank 0's result comes
back through a queue with its program log already taken in its own
process (`ctx["program_log"]`), since the program's spans live there;
the other ranks return nothing.

The window: `core.window` stops where its own process's host clock
passes the window, and ranks that disagree by one iteration would wait
for each other in the next collective for ever. So in every rank
`core.window` is replaced by the same loop whose stop test is rank 0's,
broadcast over a gloo group on the host after each iteration (a host
barrier an iteration; the card is not drained).

The host: the ranks share its cores, so each is pinned to its own
block of the cores this process may run on (`os.sched_setaffinity`),
with torch's intra-op threads cut to the block's size, and none of them
spreads its host work over the others' cores.

A deadline bounds the whole: past it, or as soon as a rank fails, every
rank is killed and `RunError` raised, so a rank that hangs fails the run
instead of hanging it.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from portbench import core

# seconds a run may take beyond its window: start-up, the GRU library's
# build, warm-up, the traced iterations and the check
DEADLINE_S = 600


def launch(measure, cell, seed, seconds, trace, start):
    return run_ranks(measure, cell, seed, seconds, trace, start,
                     ranks=cell.workload["chips"], device="cuda",
                     backend="nccl", deadline=DEADLINE_S + seconds)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def agreed_window(driver, seconds: float, device: str, phase=None, *,
                  group):
    """`core.window`, with rank 0's stop test broadcast to every rank."""
    start = time.perf_counter()
    n, metrics, ends = 0, [], []
    stop = torch.zeros(1)
    while True:
        m = driver.iterate(phase)
        metrics.append(torch.stack([m[k].float() for k in
                                    ("policy_loss", "value_loss",
                                     "dist_entropy")]))
        n += 1
        ends.append(time.perf_counter() - start)
        stop[0] = float(ends[-1] >= seconds)
        dist.broadcast(stop, src=0, group=group)
        if stop[0] > 0:
            break
    core.sync(device)
    return n, time.perf_counter() - start, metrics, ends


def core_blocks(cores, ranks: int) -> list:
    """`cores` cut into `ranks` contiguous blocks of equal size, one a
    rank (the cores left over go unused); fewer cores than ranks: rank r
    takes core r mod len(cores)."""
    cores = sorted(cores)
    per = len(cores) // ranks
    if per == 0:
        return [[cores[r % len(cores)]] for r in range(ranks)]
    return [cores[r * per:(r + 1) * per] for r in range(ranks)]


def _rank(rank, ranks, port, backend, device, measure, cell, seed, seconds,
          trace, start, out, cores):
    """One rank's process: pin it to `cores`, join the group, run
    `measure`, report."""
    try:
        os.sched_setaffinity(0, cores)
        torch.set_num_threads(len(cores))
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        # one host: the groups meet over the loopback device (a machine
        # without a network may have no other), the data over NVLink
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        from onpolicy_torch.parallel import distributed
        from portbench.metrics import _spans
        dev = distributed.initialize(rank, ranks, rank, ranks, backend,
                                     device)
        group = dist.new_group(backend="gloo")
        core.window = lambda *a: agreed_window(*a, group=group)
        ctx = measure(cell, seed, seconds, trace, start, device=str(dev))
        if rank == 0:
            _spans.program_log(ctx)
    except BaseException:
        out.put(("error", rank, traceback.format_exc()))
        raise
    out.put(("ok", rank, ctx if rank == 0 else None))
    distributed.shutdown()


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(30)


def run_ranks(measure, cell, seed, seconds, trace, start, *, ranks: int,
              device: str, backend: str, deadline: float) -> dict:
    """Run `measure` in `ranks` spawned processes joined in one process
    group; -> rank 0's ctx. Raises `core.RunError` where a rank fails or
    the ranks have not all finished `deadline` seconds after the call."""
    spawn = mp.get_context("spawn")
    out = spawn.Queue()
    port = free_port()
    blocks = core_blocks(os.sched_getaffinity(0), ranks)
    procs = [spawn.Process(
        target=_rank, daemon=True,
        args=(r, ranks, port, backend, device, measure, cell, seed, seconds,
              trace, start, out, blocks[r])) for r in range(ranks)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    done, ctx = set(), None
    try:
        while len(done) < ranks:
            try:
                status, rank, payload = out.get(timeout=1.0)
            except queue.Empty:
                left = sorted(set(range(ranks)) - done)
                # a rank that exited 0 has reported: its line is in the pipe
                gone = [r for r in left
                        if procs[r].exitcode not in (None, 0)]
                if gone:
                    raise core.RunError(
                        f"rank {gone[0]} of {ranks} exited with code "
                        f"{procs[gone[0]].exitcode} before it reported; "
                        "every rank was killed") from None
                if time.monotonic() > end:
                    raise core.RunError(
                        f"ranks {left} of {ranks} had not finished after "
                        f"{deadline:.0f} s; every rank was killed") from None
                continue
            if status == "error":
                raise core.RunError(f"rank {rank} of {ranks} failed; every "
                                    f"rank was killed:\n{payload}")
            done.add(rank)
            if rank == 0:
                ctx = payload
    except BaseException:
        _kill(procs)
        raise
    # every rank has reported: leaving the group may take a while, not
    # the run
    for p in procs:
        p.join(60)
    _kill(procs)
    return ctx
