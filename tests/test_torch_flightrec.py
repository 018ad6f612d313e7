"""torchgpipe_tpu_torch.obs.flightrec against the JAX reference.

One 2-rank step of each package's ``DistributedGPipe`` over a
``LocalTransport``, each rank with its package's ``FlightRecorder``,
must record the same events in the same order: kinds, channels (a skip
channel by its skip's name), peers, stages and micro-batches.  Times are
not compared.  The recorder's own cases (ring, dump, crash dump,
watchdog, clock alignment, merged trace) follow tests/test_flightrec.py.
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import skip as jskip
from torchgpipe_tpu.distributed import DistributedGPipe as JDistributedGPipe
from torchgpipe_tpu.distributed import LocalTransport as JLocalTransport
from torchgpipe_tpu.obs.flightrec import FlightRecorder as JFlightRecorder
from torchgpipe_tpu.ops import nn as jnn
from torchgpipe_tpu_torch import skip as tskip
from torchgpipe_tpu_torch.distributed import (
    DistributedGPipe,
    LocalTransport,
    Mailbox,
    PeerDiedError,
)
from torchgpipe_tpu_torch.obs.flightrec import (
    FlightEvent,
    FlightRecorder,
    StallWatchdog,
    align_clocks,
    load_dump,
    merged_chrome_trace,
)
from torchgpipe_tpu_torch.obs.registry import MetricsRegistry
from torchgpipe_tpu_torch.ops import nn as tnn

WORKERS = ["w0", "w1"]


def _jax_layers():
    return [jnn.dense(8, name="a"), jskip.stash("x", name="s"), jnn.dense(8, name="b"),
            jskip.pop_add("x", name="p")]


def _torch_layers():
    return [tnn.Dense(8, 8, name="a", device="cpu"), tskip.stash("x", name="s"),
            tnn.Dense(8, 8, name="b", device="cpu"), tskip.pop_add("x", name="p")]


def _channel(ch):
    if ch is None:
        return None
    kind, index = ch
    if isinstance(kind, tuple):   # ("skip", key): the skip's name
        key = kind[1]
        kind = (kind[0], key[-1] if isinstance(key, tuple) else str(key))
    return kind, index


def _events(rec):
    return [(e.kind, _channel(e.channel), e.peer, e.stage, e.mb) for e in rec.events()]


def _jax_step():
    transport = JLocalTransport()
    recs = [JFlightRecorder(rank=r, worker=w) for r, w in enumerate(WORKERS)]
    ranks = [JDistributedGPipe(_jax_layers(), r, WORKERS, [2, 2], chunks=2,
                               transport=transport, mailbox=transport.register(w),
                               recorder=recs[r]) for r, w in enumerate(WORKERS)]
    x = jnp.ones((4, 8))
    ps = [rank.init(jax.random.PRNGKey(0), jax.ShapeDtypeStruct(x.shape, x.dtype))
          for rank in ranks]
    ranks[0].forward(*ps[0], x)
    outs = ranks[1].forward(*ps[1])
    _, gys, _ = ranks[1].loss_grads(outs, x, lambda o, t: jnp.mean((o - t) ** 2))
    ranks[1].backward(gys)
    ranks[0].backward()
    return recs


def _torch_step(recs=None, transport=None):
    transport = transport or LocalTransport()
    recs = recs or [FlightRecorder(rank=r, worker=w) for r, w in enumerate(WORKERS)]
    layers = _torch_layers()
    ranks = [DistributedGPipe(layers, r, WORKERS, [2, 2], chunks=2,
                              transport=transport, mailbox=transport.register(w),
                              device="cpu", recorder=recs[r])
             for r, w in enumerate(WORKERS)]
    x = torch.ones(4, 8)
    ranks[0].forward(x)
    outs = ranks[1].forward()
    _, gys, _ = ranks[1].loss_grads(outs, x, lambda o, t: ((o - t) ** 2).mean())
    ranks[1].backward(gys)
    ranks[0].backward()
    return recs, ranks


def test_one_step_records_the_references_events():
    jrecs = _jax_step()
    recs, _ = _torch_step()
    for jrec, rec in zip(jrecs, recs):
        assert _events(rec) == _events(jrec)
        assert {k: v for k, v in rec.meta.items() if k != "skips"} == \
            {k: v for k, v in jrec.meta.items() if k != "skips"}
        assert [s[1:] for s in rec.meta["skips"]] == [s[1:] for s in jrec.meta["skips"]]
    kinds = {e.kind for e in recs[1].events()}
    assert {"forward_begin", "forward_plan", "recv_wait", "recv_match", "fwd", "send",
            "mail_put", "forward_end", "backward_begin", "bwd", "backward_end"} <= kinds


def test_ring_is_bounded_and_ordered():
    rec = FlightRecorder(capacity=5)
    for i in range(12):
        rec.record("fwd", stage=0, mb=i)
    evs = rec.events()
    assert [e.mb for e in evs] == list(range(7, 12))
    assert [e.seq for e in evs] == list(range(7, 12))
    assert rec.last_event().mb == 11


def test_dump_round_trip_keeps_channels_and_meta(tmp_path):
    recs, _ = _torch_step()
    path = recs[1].dump(str(tmp_path / "r1.json"))
    d = load_dump(path)
    assert d.rank == 1 and d.worker == "w1" and d.meta["chunks"] == 2
    assert [e.kind for e in d.events] == [e.kind for e in recs[1].events()]
    assert ("forward", 0) in [e.channel for e in d.events]
    ev = FlightEvent(3, 1.5, "recv_match", ("backward", 1), "w0", dur=0.25)
    assert FlightEvent.from_dict(ev.to_dict()) == ev
    assert recs[0].dump() is None   # no destination: an in-memory box


def test_mailbox_records_arrivals_with_depth():
    box = Mailbox("w1")
    box.recorder = rec = FlightRecorder(rank=1, worker="w1")
    box.put("forward", 0, 1)
    box.put("forward", 0, 2)
    assert [e.detail for e in rec.events() if e.kind == "mail_put"] == ["depth=1", "depth=2"]


def test_peer_death_records_and_dumps_before_raising(tmp_path):
    transport = LocalTransport()
    rec = FlightRecorder(dump_path=str(tmp_path / "rank1.json"))
    rank1 = DistributedGPipe(_torch_layers(), 1, WORKERS, [2, 2], chunks=2,
                             transport=transport, mailbox=transport.register("w1"),
                             device="cpu", recv_timeout=0.1, recorder=rec)
    with pytest.raises(PeerDiedError):
        rank1.forward()
    kinds = [e.kind for e in load_dump(str(tmp_path / "rank1.json")).events]
    assert kinds[-3:] == ["recv_wait", "peer_died", "crash"]
    assert rec.rank == 1 and rec.meta["engine"] == "distributed"


def test_watchdog_flags_silence_then_clears(tmp_path):
    rec = FlightRecorder(rank=0, worker="w0", dump_path=str(tmp_path / "wd.json"))
    rec.record("forward_begin")
    reg = MetricsRegistry()
    with StallWatchdog(rec, timeout=0.15, poll=0.03, registry=reg) as wd:
        deadline = time.monotonic() + 5.0
        while not wd.stalled and time.monotonic() < deadline:
            time.sleep(0.03)
        assert wd.stalled
        assert reg.get("hang_suspected").value(rank="0") == 1.0
        assert any(e.kind == "stall_suspected"
                   for e in load_dump(str(tmp_path / "wd.json")).events)
        rec.record("fwd", stage=0, mb=0, dur=0.001)
        deadline = time.monotonic() + 5.0
        while wd.stalled and time.monotonic() < deadline:
            time.sleep(0.03)
        assert not wd.stalled
        assert reg.get("hang_suspected").value(rank="0") == 0.0


def test_preemption_hook_dumps_the_ring(tmp_path):
    from torchgpipe_tpu_torch.resilience.preemption import PreemptionHandler

    rec = FlightRecorder(rank=0, worker="w0", dump_path=str(tmp_path / "term.json"))
    rec.record("forward_begin")
    handler = PreemptionHandler()
    handler.add_callback(rec.dump)
    handler.simulate()
    assert any(e.kind == "forward_begin"
               for e in load_dump(str(tmp_path / "term.json")).events)


def test_align_clocks_and_merged_trace(tmp_path):
    transport = LocalTransport()
    boxes = [transport.register(w) for w in WORKERS]
    recs = [FlightRecorder(rank=r, worker=w) for r, w in enumerate(WORKERS)]
    offsets = [None, None]

    def run(r):
        offsets[r] = align_clocks(transport, boxes[r], r, WORKERS, recs[r], timeout=10)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert offsets[0] == 0.0 and abs(offsets[1]) < 0.5
    assert recs[1].clock_offset == offsets[1]
    for b in boxes:
        b.recorder = None
    for w in WORKERS:
        transport.unregister(w)
    _torch_step(recs, transport)
    merged_chrome_trace(recs, str(tmp_path / "trace.json"))
    trace = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    names = {e["name"] for e in trace}
    assert "fwd(s0,mb0)" in names and "bwd(s1,mb1)" in names
    assert {e["pid"] for e in trace} == {0, 1}
    assert np.isfinite([e.get("ts", 0.0) for e in trace]).all()
