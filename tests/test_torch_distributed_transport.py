"""torchgpipe_tpu_torch.distributed.context: mailboxes, the local and TCP
transports, and the faulty transport of resilience.faults, with the
cases of tests/distributed/test_context.py.  Payloads must cross the TCP
transport bitwise, bf16 included (numpy has none: the port frames raw
bytes), and arrive on the CPU."""

import socket
import threading
import time

import pytest
import torch

from torchgpipe_tpu_torch.distributed import LocalTransport, Mailbox, PeerDiedError, TcpTransport
from torchgpipe_tpu_torch.distributed.context import _retry_sleep_s, decode, encode
from torchgpipe_tpu_torch.obs.flightrec import FlightRecorder
from torchgpipe_tpu_torch.obs.registry import MetricsRegistry
from torchgpipe_tpu_torch.resilience import faults
from torchgpipe_tpu_torch.resilience.guard import classify_error


def _ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.contiguous().reshape(-1).view(torch.uint8) if a.numel() else a,
                                b.contiguous().reshape(-1).view(torch.uint8) if b.numel() else b))
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _payload():
    g = torch.Generator().manual_seed(0)
    bf = torch.randn(3, 5, generator=g).to(torch.bfloat16)
    bf[0, 0] = float("nan")
    return {
        "act": bf,
        "strided": torch.randn(4, 6, generator=g)[:, ::2],
        "nested": [1, None, (torch.arange(5), "name", 2.5, torch.tensor(True))],
        "empty": torch.empty(0, 3, dtype=torch.float16),
        "scalar": torch.tensor(-0.0, dtype=torch.float64),
        "ints": torch.tensor([-(2 ** 40), 3], dtype=torch.int64),
    }


def test_mailbox_channels_are_independent():
    box = Mailbox("w")
    box.put("forward", 0, "a")
    box.put("forward", 1, "b")
    box.put("backward", 0, "c")
    assert box.depth("forward", 0) == 1
    assert box.get("forward", 1) == "b"
    assert box.get("backward", 0) == "c"
    assert box.get("forward", 0) == "a"
    assert box.depth("forward", 0) == 0


def test_mailbox_get_blocks_until_put_and_counts_the_wait():
    box = Mailbox("w")
    threading.Timer(0.1, lambda: box.put("forward", 0, 7)).start()
    assert box.get("forward", 0, timeout=5) == 7
    assert box.wait_s >= 0.05


def test_mailbox_timeout_names_the_channel():
    with pytest.raises(TimeoutError, match=r"worker 'w'.*\('forward', 3\)"):
        Mailbox("w").get("forward", 3, timeout=0.05)


def test_local_transport_unknown_worker_and_liveness():
    t = LocalTransport()
    t.register("a")
    with pytest.raises(KeyError, match="unknown worker 'b'"):
        t.send("b", "forward", 0, 1)
    with pytest.raises(ValueError, match="already registered"):
        t.register("a")
    assert t.is_alive("a") and not t.is_alive("b")


def test_encode_decode_is_bitwise():
    p = _payload()
    skeleton, buffers = encode(p)
    assert _same(decode(skeleton, [bytearray(b) for b in buffers]), p)


def test_tcp_transport_roundtrip_bitwise_and_liveness():
    ports = _ports(2)
    addr = {"a": ("127.0.0.1", ports[0]), "b": ("127.0.0.1", ports[1])}
    reg = MetricsRegistry()
    ta, tb = TcpTransport("a", addr, registry=reg), TcpTransport("b", addr)
    try:
        p = _payload()
        ta.send("b", ("skip", ("ns", "x")), 2, p)
        got = tb.mailbox.get(("skip", ("ns", "x")), 2, timeout=10)
        assert _same(got, p)
        assert got["act"].dtype == torch.bfloat16 and got["act"].device.type == "cpu"
        assert ta.bytes_sent > 3 * 5 * 2
        # A liveness probe connects and delivers nothing.
        assert ta.is_alive("b") and tb.mailbox.depth(("skip", ("ns", "x")), 2) == 0
        with pytest.raises(ValueError, match="exactly one worker"):
            ta.register("b")
    finally:
        tb.close()
    assert not ta.is_alive("b")
    ta.connect_timeout = 0.3
    with pytest.raises(TimeoutError, match="could not reach 'b'"):
        ta.send("b", "forward", 0, 1)
    assert reg.counter("retries_total", labels=("rank",)).value(rank="a") >= 1
    ta.close()


def test_tcp_connect_retries_are_recorded_before_the_raise():
    ports = _ports(2)
    rec = FlightRecorder(rank=0, worker="a")
    ta = TcpTransport("a", {"a": ("127.0.0.1", ports[0]), "b": ("127.0.0.1", ports[1])},
                      connect_timeout=0.4, recorder=rec)
    try:
        with pytest.raises(TimeoutError):
            ta.send("b", "forward", 0, torch.zeros(2))
    finally:
        ta.close()
    kinds = [e.kind for e in rec.events()]
    assert kinds[0] == "connect_retry" and kinds[-1] == "connect_timeout"
    assert all(e.channel == ("forward", 0) and e.peer == "b" for e in rec.events())


def test_retry_backoff_is_capped_and_jittered():
    import random

    rng = random.Random(0)
    sleeps = [_retry_sleep_s(a, rng) for a in range(1, 12)]
    assert 0.25 <= sleeps[0] <= 0.5
    assert all(s <= 5.0 for s in sleeps) and max(sleeps) >= 2.5


@pytest.mark.parametrize("action", ["drop", "lose", "delay", "duplicate"])
def test_faulty_transport_actions(action):
    inner = LocalTransport()
    box = inner.register("b")
    t = faults.FaultyTransport(inner, [faults.SendFault(action, dst="b", kind="forward",
                                                        index=0, delay_s=0.05)])
    t0 = time.perf_counter()
    if action == "drop":
        with pytest.raises(ConnectionError) as err:
            t.send("b", "forward", 0, 1)
        assert classify_error(err.value) == "transient"
    else:
        t.send("b", "forward", 0, 1)
    assert box.depth("forward", 0) == {"drop": 0, "lose": 0, "delay": 1, "duplicate": 2}[action]
    if action == "delay":
        assert time.perf_counter() - t0 >= 0.05
    t.send("b", "forward", 0, 2)   # fired once: passes clean now
    assert t.log == [(action, "b", "forward", 0)]
    assert t.is_alive("b")   # delegated


def test_faulty_transport_hang_until_release():
    inner = LocalTransport()
    box = inner.register("b")
    t = faults.FaultyTransport(inner, hang_at=("backward", 1))
    th = threading.Thread(target=t.send, args=("b", "backward", 1, 9), daemon=True)
    th.start()
    time.sleep(0.1)
    assert th.is_alive()
    t.release()
    th.join(5)
    assert not th.is_alive() and box.depth("backward", 1) == 0
    t.send("b", "backward", 1, 9)
    assert box.depth("backward", 1) == 1
    assert faults.plan_token() is None


def test_send_fault_rejects_unknown_actions():
    with pytest.raises(ValueError, match="action must be one of"):
        faults.SendFault("explode")


def test_peer_died_error_is_fatal_and_named():
    err = PeerDiedError(2, "w2", "gone")
    assert isinstance(err, TimeoutError)
    assert classify_error(err) == "fatal"
    assert classify_error(TimeoutError()) == "transient"
    assert str(err) == "peer rank 2 ('w2') is dead: gone"
