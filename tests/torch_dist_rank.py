"""One rank of a 2-rank ``torchgpipe_tpu_torch.distributed`` pipeline on
the CPU, over ``TcpTransport`` on localhost (each rank of
tests/test_torch_distributed_procs.py)::

    python tests/torch_dist_rank.py --rank 0 --ports 40000,40001 --out DIR \\
        --steps 2 [--start 0] [--resume] [--save] [--step-sleep S]

The model is a float32 MLP whose skip is stashed on rank 0 and popped on
rank 1, with a dropout keyed by the step (:func:`build`); the data of
step ``k`` comes from ``numpy.random.default_rng(k)`` (:func:`batch`),
and each step is one SGD update.  After each step the rank appends its
line to ``DIR/rank<r>.jsonl`` (the last rank with the loss); with
``--save`` it writes its stage with ``utils.serialization.save`` to
``DIR/rank<r>.npz`` at the end, and ``--resume`` loads that file first.
At the end it writes its parameters to ``DIR/rank<r>_params.pt``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from torchgpipe_tpu_torch import skip as tskip
from torchgpipe_tpu_torch.distributed import (
    DistributedGPipe,
    DistributedGPipeDataLoader,
    TcpTransport,
)
from torchgpipe_tpu_torch.obs.flightrec import align_clocks
from torchgpipe_tpu_torch.ops import nn as tnn
from torchgpipe_tpu_torch.utils import serialization

WORKERS = ["r0", "r1"]
BALANCE = [3, 5]
CHUNKS = 2
LR = 0.1


def build():
    """The model every rank builds from one seed."""
    gen = torch.Generator().manual_seed(0)

    def dense(i, o, name):
        return tnn.Dense(i, o, name=name, device="cpu", generator=gen)

    return [dense(8, 16, "fc1"), tnn.ReLU("r1"), tskip.stash("x", name="s"),
            dense(16, 16, "fc2"), tnn.Dropout(0.25, name="drop"), tnn.ReLU("r2"),
            tskip.pop_add("x", name="p"), dense(16, 4, "fc3")]


def batch(step):
    rng = np.random.default_rng(step)
    return (torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)))


def loss_fn(out, tgt):
    return ((out - tgt) ** 2).mean()


def rng_of(step):
    return 100 + step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--ports", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save", action="store_true")
    ap.add_argument("--step-sleep", type=float, default=0.0)
    ap.add_argument("--recv-timeout", type=float, default=30.0)
    args = ap.parse_args()
    torch.set_num_threads(1)
    ports = [int(p) for p in args.ports.split(",")]
    addresses = {w: ("127.0.0.1", p) for w, p in zip(WORKERS, ports)}
    transport = TcpTransport(WORKERS[args.rank], addresses, connect_timeout=60.0)
    box = transport.register(WORKERS[args.rank])
    pipe = DistributedGPipe(build(), args.rank, WORKERS, BALANCE, chunks=CHUNKS,
                            transport=transport, mailbox=box, device="cpu",
                            recv_timeout=args.recv_timeout)
    if args.resume:
        serialization.load_state_dict(
            pipe, serialization.load(os.path.join(args.out, f"rank{args.rank}.npz")))
    opt = torch.optim.SGD(list(pipe.parameters()), lr=LR)
    # Both listeners are up once the clock handshake is through: from
    # here on a refused connect means a dead peer, so fail fast.
    align_clocks(transport, box, args.rank, WORKERS, timeout=60.0)
    transport.connect_timeout = 2.0
    steps = range(args.start, args.start + args.steps)
    data = [batch(k) for k in steps] if args.rank == 0 else None
    loader = DistributedGPipeDataLoader(data, args.rank, WORKERS, transport=transport,
                                        mailbox=box, num_batches=len(steps),
                                        recv_timeout=args.recv_timeout)
    log = open(os.path.join(args.out, f"rank{args.rank}.jsonl"), "a")
    for step, (x, y) in zip(steps, loader):
        outs = pipe.forward(x, rng=rng_of(step))
        line = {"step": step}
        if pipe.is_last:
            loss, gys, _ = pipe.loss_grads(outs, y, loss_fn)
            pipe.backward(gys)
            line["loss"] = loss.item()
            line["loss_bits"] = int(loss.view(torch.int32).item())
        else:
            pipe.backward()
        opt.step()
        log.write(json.dumps(line) + "\n")
        log.flush()
        time.sleep(args.step_sleep)
    if args.save:
        serialization.save(os.path.join(args.out, f"rank{args.rank}.npz"),
                           serialization.state_dict(pipe))
    torch.save([p.detach() for p in pipe.parameters()],
               os.path.join(args.out, f"rank{args.rank}_params.pt"))
    log.write(json.dumps({"done": True, "bytes_sent": transport.bytes_sent,
                          "wait_s": box.wait_s}) + "\n")
    log.close()
    transport.close()


if __name__ == "__main__":
    sys.exit(main())
