"""Two real OS processes of torchgpipe_tpu_torch.distributed over
``TcpTransport`` on localhost, on the CPU (tests/torch_dist_rank.py is
each rank):

* two processes train bitwise equal to the same ranks driven in this
  process over a ``LocalTransport``, and resume bitwise after a restart
  from each rank's ``utils.serialization.save``;
* a rank killed with SIGKILL surfaces on its peer as a
  ``PeerDiedError`` naming it, not as a hang.
"""

import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import time

import torch

from tests import torch_dist_rank as R
from tests.subproc_env import REPO, cpu_subproc_env
from torchgpipe_tpu_torch.distributed import DistributedGPipe, LocalTransport

SCRIPT = os.path.join(REPO, "tests", "torch_dist_rank.py")


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _launch(out, *extra):
    ports = ",".join(str(p) for p in _free_ports(2))
    procs = []
    for rank in range(2):
        log = open(os.path.join(out, f"rank{rank}.log"), "ab")
        procs.append((subprocess.Popen(
            [sys.executable, SCRIPT, "--rank", str(rank), "--ports", ports,
             "--out", out, *extra],
            cwd=REPO, env=cpu_subproc_env(), stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, timeout):
    try:
        deadline = time.time() + timeout
        return [p.wait(timeout=max(1.0, deadline - time.time())) for p, _ in procs]
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


def _log(out, rank, ext="log"):
    with open(os.path.join(out, f"rank{rank}.{ext}")) as f:
        return f.read()


@contextlib.contextmanager
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def _in_process(steps):
    """The same ranks in this process: per-step loss bits, final params."""
    transport = LocalTransport()
    layers = R.build()
    ranks = [DistributedGPipe(layers, r, R.WORKERS, R.BALANCE, chunks=R.CHUNKS,
                              transport=transport, mailbox=transport.register(w),
                              device="cpu") for r, w in enumerate(R.WORKERS)]
    opts = [torch.optim.SGD(list(r.parameters()), lr=R.LR) for r in ranks]
    bits = []
    with _one_thread():
        for step in range(steps):
            x, y = R.batch(step)
            ranks[0].forward(x, rng=R.rng_of(step))
            outs = ranks[1].forward(rng=R.rng_of(step))
            loss, gys, _ = ranks[1].loss_grads(outs, y, R.loss_fn)
            ranks[1].backward(gys)
            ranks[0].backward()
            for opt in opts:
                opt.step()
            bits.append(int(loss.view(torch.int32).item()))
    return bits, [[p.detach() for p in r.parameters()] for r in ranks]


def test_two_processes_train_and_resume_bitwise(tmp_path):
    out = str(tmp_path)
    rcs = _wait(_launch(out, "--steps", "2", "--save"), 120)
    assert rcs == [0, 0], _log(out, 0) + _log(out, 1)
    rcs = _wait(_launch(out, "--steps", "1", "--start", "2", "--resume"), 120)
    assert rcs == [0, 0], _log(out, 0) + _log(out, 1)
    lines = [json.loads(x) for x in _log(out, 1, "jsonl").splitlines()]
    got = [x["loss_bits"] for x in lines if "loss_bits" in x]
    want, params = _in_process(3)
    assert got == want
    for rank in range(2):
        saved = torch.load(os.path.join(out, f"rank{rank}_params.pt"))
        assert all(torch.equal(a, b) for a, b in zip(saved, params[rank]))
    done = [json.loads(x) for x in _log(out, 0, "jsonl").splitlines() if "done" in x]
    # Rank 0 framed its activations, skips and targets: bytes crossed.
    assert done and done[-1]["bytes_sent"] > 0


def test_killed_rank_surfaces_as_a_named_peer_died_error(tmp_path):
    out = str(tmp_path)
    procs = _launch(out, "--steps", "1000", "--step-sleep", "0.02",
                    "--recv-timeout", "3")
    try:
        deadline = time.time() + 90
        while time.time() < deadline:
            if os.path.exists(os.path.join(out, "rank1.jsonl")) and \
                    '"step": 0' in _log(out, 1, "jsonl"):
                break
            assert all(p.poll() is None for p, _ in procs), _log(out, 0) + _log(out, 1)
            time.sleep(0.05)
        procs[1][0].send_signal(signal.SIGKILL)
        rc0 = procs[0][0].wait(timeout=60)
    finally:
        _wait(procs, 5)
    log = _log(out, 0)
    assert rc0 != 0, log
    assert "PeerDiedError: peer rank 1 ('r1') is dead" in log, log
