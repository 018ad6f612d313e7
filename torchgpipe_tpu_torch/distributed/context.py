"""Named mailboxes and pluggable transports for the multi-process pipeline.

Counterpart of ``torchgpipe_tpu/distributed/context.py``: each worker
owns a :class:`Mailbox` of blocking FIFO channels keyed by ``(kind,
index)``; forward activations, backward cotangents, targets, the
micro-batch count and cross-rank skips (``("skip", key)``,
``("skip_grad", key)``) all travel through it.

* :class:`LocalTransport` delivers between rank objects in one process
  (the tests drive ranks one after another this way).  A payload is
  handed over as it is, as the single-process ``GPipe`` hands a stage's
  output to the next.
* :class:`TcpTransport` sends length-prefixed frames over TCP between
  OS processes.  Payloads are staged through the host: a CUDA tensor is
  copied to the CPU and framed as its dtype, shape and raw bytes (bf16
  stays bf16 on the wire), and the receiver puts it on its own device.
  Nested tuples, lists and dicts of tensors, numbers, strings and
  ``None`` cross bitwise.

``Mailbox.wait_s`` and ``TcpTransport.bytes_sent`` count the seconds a
rank spent blocked in :meth:`Mailbox.get` and the bytes it framed.
"""

from __future__ import annotations

import contextlib
import pickle
import queue
import random
import socket
import socketserver
import struct
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

Payload = Any
ChannelKey = Tuple[Any, int]

# Connect-retry backoff: exponential from BASE, capped at CAP, half of
# each sleep jittered so ranks that lost one peer do not reconnect in
# lockstep.
RETRY_BACKOFF_BASE_S = 0.5
RETRY_BACKOFF_CAP_S = 5.0


def _retry_sleep_s(attempt: int, rng: random.Random) -> float:
    """Sleep before connect retry ``attempt`` (1-based): equal-jitter
    exponential backoff, ``base * 2**(attempt-1)`` capped at
    :data:`RETRY_BACKOFF_CAP_S`, half of it jittered uniformly."""
    ceiling = min(
        RETRY_BACKOFF_CAP_S,
        RETRY_BACKOFF_BASE_S * (2.0 ** max(attempt - 1, 0)),
    )
    return ceiling / 2.0 + rng.random() * ceiling / 2.0


class PeerDiedError(TimeoutError):
    """A peer rank is confirmed dead, not merely slow: it missed a
    deadline and failed the transport's liveness probe
    (``transport.is_alive``).  Names the rank, so that the right worker
    is restarted.  A ``TimeoutError``, but
    :func:`~torchgpipe_tpu_torch.resilience.guard.classify_error` calls
    it fatal: channels may hold stale messages, so recovery is a restart
    from a checkpoint, not a retry."""

    def __init__(self, rank: int, worker: str, detail: str = "") -> None:
        self.rank = rank
        self.worker = worker
        super().__init__(
            f"peer rank {rank} ({worker!r}) is dead"
            + (f": {detail}" if detail else "")
        )


class Mailbox:
    """Blocking channels keyed by ``(kind, micro-batch index)``, created
    on demand.  ``recorder`` (a
    :class:`~torchgpipe_tpu_torch.obs.flightrec.FlightRecorder`) turns
    each delivery into a ``mail_put`` event with the channel's depth;
    deliveries come from transport threads, so the recorder locks."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.recorder: Optional[Any] = None
        self.wait_s = 0.0
        self._channels: Dict[ChannelKey, queue.Queue] = {}
        self._lock = threading.Lock()

    def _channel(self, kind: Any, index: int) -> queue.Queue:
        key = (kind, index)
        with self._lock:
            ch = self._channels.get(key)
            if ch is None:
                ch = self._channels[key] = queue.Queue()
            return ch

    def depth(self, kind: Any, index: int) -> int:
        """Messages queued on one channel."""
        with self._lock:
            ch = self._channels.get((kind, index))
        return ch.qsize() if ch is not None else 0

    def put(self, kind: Any, index: int, payload: Payload) -> None:
        ch = self._channel(kind, index)
        ch.put(payload)
        rec = self.recorder
        if rec is not None:
            rec.record("mail_put", channel=(kind, index),
                       detail=f"depth={ch.qsize()}")

    def get(self, kind: Any, index: int, timeout: Optional[float] = None) -> Payload:
        t0 = time.perf_counter()
        try:
            return self._channel(kind, index).get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(
                f"worker {self.name!r}: no message on channel {(kind, index)!r} "
                f"within {timeout}s — is the peer rank alive?"
            ) from None
        finally:
            self.wait_s += time.perf_counter() - t0


class LocalTransport:
    """In-process transport: a shared registry of mailboxes."""

    def __init__(self) -> None:
        self._mailboxes: Dict[str, Mailbox] = {}

    def register(self, name: str) -> Mailbox:
        if name in self._mailboxes:
            raise ValueError(f"worker {name!r} already registered")
        box = Mailbox(name)
        self._mailboxes[name] = box
        return box

    def unregister(self, name: str) -> None:
        self._mailboxes.pop(name, None)

    def send(self, dst: str, kind: Any, index: int, payload: Payload) -> None:
        try:
            box = self._mailboxes[dst]
        except KeyError:
            raise KeyError(
                f"unknown worker {dst!r}; registered: {sorted(self._mailboxes)}"
            ) from None
        box.put(kind, index, payload)

    def is_alive(self, name: str) -> bool:
        """Liveness is registration (a dead in-process rank unregisters in
        :func:`worker`'s ``finally``)."""
        return name in self._mailboxes


# --------------------------------------------------------------------- #
# framing                                                               #
# --------------------------------------------------------------------- #


class _TensorRef:
    """A tensor's place in a framed payload: its dtype, shape and the
    index of its bytes among the frame's buffers."""

    __slots__ = ("index", "dtype", "shape")

    def __init__(self, index: int, dtype: torch.dtype, shape: Tuple[int, ...]) -> None:
        self.index, self.dtype, self.shape = index, dtype, shape

    def __reduce__(self) -> Any:
        return (_TensorRef, (self.index, str(self.dtype).split(".")[-1], self.shape))


def _host_bytes(t: torch.Tensor) -> memoryview:
    """A tensor's bytes on the host, in its own dtype."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return memoryview(t.view(torch.uint8).numpy()) if t.numel() else memoryview(b"")


def encode(payload: Payload) -> Tuple[bytes, List[memoryview]]:
    """A payload as a pickled skeleton (tensors replaced by
    :class:`_TensorRef`) and the tensors' raw bytes."""
    buffers: List[memoryview] = []

    def strip(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            buffers.append(_host_bytes(x))
            return _TensorRef(len(buffers) - 1, x.dtype, tuple(x.shape))
        if isinstance(x, tuple):
            return tuple(strip(v) for v in x)
        if isinstance(x, list):
            return [strip(v) for v in x]
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()}
        return x

    skeleton = strip(payload)
    return pickle.dumps(skeleton, protocol=pickle.HIGHEST_PROTOCOL), buffers


def decode(skeleton: bytes, buffers: List[bytearray]) -> Payload:
    """The payload :func:`encode` framed, its tensors on the CPU."""

    def fill(x: Any) -> Any:
        if isinstance(x, _TensorRef):
            dtype = getattr(torch, x.dtype) if isinstance(x.dtype, str) else x.dtype
            raw = buffers[x.index]
            if not len(raw):
                return torch.empty(x.shape, dtype=dtype)
            return torch.frombuffer(raw, dtype=torch.uint8).view(dtype).reshape(x.shape)
        if isinstance(x, tuple):
            return tuple(fill(v) for v in x)
        if isinstance(x, list):
            return [fill(v) for v in x]
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        return x

    return fill(pickle.loads(skeleton))


def _recv_exact(sock: Any, n: int) -> Optional[bytearray]:
    buf = bytearray(n)
    view, got = memoryview(buf), 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            return None
        got += k
    return buf


class _MsgHandler(socketserver.BaseRequestHandler):
    """One frame per connection: ``!Q`` header length, ``!I`` buffer
    count, ``!Q`` per buffer length, the pickled ``(kind, index,
    skeleton)``, then the buffers.  A connection closed before its first
    byte (a liveness probe) delivers nothing."""

    def handle(self) -> None:
        head = _recv_exact(self.request, 12)
        if head is None:
            return
        hlen, nbuf = struct.unpack("!QI", head)
        sizes = _recv_exact(self.request, 8 * nbuf) if nbuf else bytearray()
        header = _recv_exact(self.request, hlen)
        if sizes is None or header is None:
            return
        buffers = []
        for (n,) in struct.iter_unpack("!Q", sizes):
            buf = _recv_exact(self.request, n) if n else bytearray()
            if buf is None:
                return
            buffers.append(buf)
        kind, index, skeleton = pickle.loads(header)
        self.server.mailbox.put(kind, index, decode(skeleton, buffers))  # type: ignore[attr-defined]


class TcpTransport:
    """Socket transport between OS processes, one listener per worker.

    ``addresses`` maps every worker name to ``(host, port)``; this worker
    binds its own and receives into :attr:`mailbox`.  A send connects
    (retrying refused or silent connects with capped, jittered backoff
    until ``connect_timeout``: the peer's listener may not be up yet),
    then writes one frame; ``send_timeout`` bounds the write.
    ``recorder`` records each connect retry, the connect timeout and a
    send timeout before raising; ``registry`` (a
    :class:`~torchgpipe_tpu_torch.obs.registry.MetricsRegistry`) counts
    the retries in ``retries_total{rank}``.
    """

    def __init__(
        self,
        name: str,
        addresses: Dict[str, Tuple[str, int]],
        *,
        connect_timeout: float = 120.0,
        send_timeout: Optional[float] = None,
        recorder: Optional[Any] = None,
        registry: Optional[Any] = None,
    ) -> None:
        self.name = name
        self.addresses = dict(addresses)
        self.connect_timeout = connect_timeout
        self.send_timeout = send_timeout
        self.recorder = recorder
        self.bytes_sent = 0
        # Deterministic per-rank jitter (crc32: str hashes are salted).
        self._retry_rng = random.Random(zlib.crc32(name.encode("utf-8")))
        self._c_retries = (
            registry.counter(
                "retries_total",
                help="connect-retry attempts by the retrying rank",
                labels=("rank",),
            ) if registry is not None else None
        )
        self.mailbox = Mailbox(name)
        self.mailbox.recorder = recorder
        host, port = self.addresses[name]
        self._server = socketserver.ThreadingTCPServer(
            (host, port), _MsgHandler, bind_and_activate=False
        )
        self._server.daemon_threads = True
        self._server.allow_reuse_address = True
        self._server.server_bind()
        self._server.server_activate()
        self._server.mailbox = self.mailbox  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def register(self, name: str) -> Mailbox:
        if name != self.name:
            raise ValueError(
                f"TcpTransport for {self.name!r} cannot register {name!r}; "
                "each process owns exactly one worker"
            )
        return self.mailbox

    def _connect(self, dst: str, kind: Any, index: int) -> socket.socket:
        host, port = self.addresses[dst]
        deadline = time.monotonic() + self.connect_timeout
        attempt = 0
        while True:
            # Each attempt gets at most the deadline's remainder.
            per_attempt = min(30.0, max(deadline - time.monotonic(), 0.01))
            try:
                return socket.create_connection((host, port), timeout=per_attempt)
            except (ConnectionRefusedError, ConnectionResetError,
                    ConnectionAbortedError, socket.timeout) as err:
                attempt += 1
                if self._c_retries is not None:
                    self._c_retries.inc(rank=self.name)
                if self.recorder is not None:
                    self.recorder.record(
                        "connect_retry", channel=(kind, index), peer=dst,
                        detail=f"attempt={attempt} {type(err).__name__}",
                    )
                if time.monotonic() >= deadline:
                    if self.recorder is not None:
                        self.recorder.record(
                            "connect_timeout", channel=(kind, index), peer=dst,
                            detail=f"{attempt} attempts over {self.connect_timeout}s",
                        )
                    raise TimeoutError(
                        f"worker {self.name!r} could not reach {dst!r} at "
                        f"{host}:{port} within {self.connect_timeout}s — is "
                        "that rank running?"
                    ) from err
                time.sleep(_retry_sleep_s(attempt, self._retry_rng))

    def send(self, dst: str, kind: Any, index: int, payload: Payload) -> None:
        skeleton, buffers = encode(payload)
        header = pickle.dumps((kind, index, skeleton), protocol=pickle.HIGHEST_PROTOCOL)
        sizes = [b.nbytes for b in buffers]
        prefix = struct.pack(f"!QI{len(sizes)}Q", len(header), len(sizes), *sizes)
        total = len(prefix) + len(header) + sum(sizes)
        sock = self._connect(dst, kind, index)
        with sock:
            # send_timeout bounds the whole write (a peer that stops
            # reading); the connect timeout does not govern it.
            sock.settimeout(self.send_timeout)
            try:
                sock.sendall(prefix + header)
                for b in buffers:
                    if b.nbytes:
                        sock.sendall(b)
            except socket.timeout:
                if self.recorder is not None:
                    self.recorder.record(
                        "send_timeout", channel=(kind, index), peer=dst,
                        detail=f"{total} bytes, send_timeout={self.send_timeout}s",
                    )
                raise TimeoutError(
                    f"worker {self.name!r}: send of {total} bytes to "
                    f"{dst!r} did not complete within {self.send_timeout}s "
                    "— is that rank still consuming?"
                ) from None
        self.bytes_sent += total

    def is_alive(self, name: str, *, probe_timeout: float = 2.0) -> bool:
        """Can ``name``'s listener accept a connection?  A probe that
        connects and closes delivers nothing (see ``_MsgHandler``)."""
        if name == self.name:
            return True
        host, port = self.addresses[name]
        try:
            with socket.create_connection((host, port), timeout=probe_timeout):
                return True
        except OSError:
            return False

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


@contextlib.contextmanager
def worker(transport: Any, name: str) -> Iterator[Mailbox]:
    """Register a worker's mailbox for the duration of a run, and
    unregister it (where the transport can) at exit."""
    box = transport.register(name)
    try:
        yield box
    finally:
        unregister = getattr(transport, "unregister", None)
        if unregister is not None:
            unregister(name)
