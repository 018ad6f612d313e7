"""Input-pipeline utilities: sequence packing and device prefetch.

Counterpart of ``torchgpipe_tpu/utils/data.py`` (``Packing``,
``pack_documents``, ``packed_batches``, ``padded_batches``,
``real_token_fraction``, ``prefetch_to_device``, ``pipe_data_sharding``,
``prefetch_to_pipe``).  Packing places a
ragged corpus, whole documents only, into fixed ``[B, S]`` blocks by a
deterministic greedy first fit, so re-packing the same corpus (on
resume) replays the same layout.  Each block carries ``segment_ids``
(0 = pad, 1.. per document), per-token ``positions`` that restart at
each document, within-document next-token ``labels`` and ``weights``
that are 1 on real supervised positions: what the packed embedding,
attention mask and ``models.transformer.packed_cross_entropy`` take.
Arrays are host numpy arrays (int32 tokens, float32 weights), as the
reference's; :func:`prefetch_to_device` turns them into tensors on the
card; :func:`prefetch_to_pipe` onto a pipe's first stage.

The SPMD placements (``pipe_data_sharding`` of an SPMD pipe,
``global_batch_from_local``) are not ported yet (ROADMAP.md, queue A
item 5.4).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

Pytree = Any


@dataclasses.dataclass(frozen=True)
class Packing:
    """The result of :func:`pack_documents`: ``[R, S]`` arrays of ``R``
    blocks (``tokens``, ``segment_ids``, ``positions``, ``labels`` int32,
    ``weights`` float32), and per input document ``doc_locs`` (row,
    offset, length) in input order."""

    tokens: np.ndarray
    segment_ids: np.ndarray
    positions: np.ndarray
    labels: np.ndarray
    weights: np.ndarray
    doc_locs: Tuple[Tuple[int, int, int], ...]
    block_len: int
    pad_id: int

    @property
    def n_blocks(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def n_real_tokens(self) -> int:
        return int(np.sum(self.segment_ids != 0))

    @property
    def pad_fraction(self) -> float:
        """Fraction of block positions that hold pad, not document."""
        total = self.tokens.size
        return 1.0 - (self.n_real_tokens / total) if total else 0.0


def pack_documents(docs: Sequence[Any], block_len: int, *, pad_id: int = 0) -> Packing:
    """Greedy first-fit packing of ``docs`` (1-D int token arrays) into
    ``block_len``-token blocks: each document goes whole into the first
    open block with room, else a new block opens.  A document longer
    than ``block_len`` is a ``ValueError`` (packing never splits one)."""
    if block_len < 2:
        raise ValueError(f"block_len must be >= 2, got {block_len}")
    arrs = [np.asarray(d, np.int32).reshape(-1) for d in docs]
    for i, a in enumerate(arrs):
        if a.size < 1:
            raise ValueError(f"document {i} is empty")
        if a.size > block_len:
            raise ValueError(
                f"document {i} has {a.size} tokens > block_len="
                f"{block_len}; packing never splits a document across "
                "blocks — raise block_len or pre-chunk the corpus"
            )
    free: List[int] = []
    locs: List[Tuple[int, int, int]] = []
    for a in arrs:
        for r, f in enumerate(free):
            if a.size <= f:
                row = r
                break
        else:
            row = len(free)
            free.append(block_len)
        locs.append((row, block_len - free[row], a.size))
        free[row] -= a.size
    R = len(free)
    tokens = np.full((R, block_len), pad_id, np.int32)
    seg = np.zeros((R, block_len), np.int32)
    pos = np.zeros((R, block_len), np.int32)
    labels = np.full((R, block_len), pad_id, np.int32)
    weights = np.zeros((R, block_len), np.float32)
    per_row_seg = [0] * R
    for a, (r, off, n) in zip(arrs, locs):
        per_row_seg[r] += 1
        tokens[r, off:off + n] = a
        seg[r, off:off + n] = per_row_seg[r]
        pos[r, off:off + n] = np.arange(n)
        # Position i predicts token i + 1 of the same document; the
        # document's last token supervises nothing.
        labels[r, off:off + n - 1] = a[1:]
        weights[r, off:off + n - 1] = 1.0
    return Packing(tokens=tokens, segment_ids=seg, positions=pos, labels=labels,
                   weights=weights, doc_locs=tuple(locs), block_len=block_len,
                   pad_id=pad_id)


def _batch_of(packing: Packing, rows: np.ndarray) -> Tuple[Pytree, Pytree]:
    x = {"tokens": packing.tokens[rows], "segment_ids": packing.segment_ids[rows],
         "positions": packing.positions[rows]}
    y = {"labels": packing.labels[rows], "weights": packing.weights[rows]}
    return x, y


def packed_batches(
    packing: Packing, batch_rows: int, *, start: int = 0
) -> Iterator[Tuple[Pytree, Pytree]]:
    """``(x, y)`` batches of ``batch_rows`` blocks, all one shape: a
    short last batch is topped up with all-pad rows (segment 0, weight
    0).  ``start=k`` resumes at batch ``k``, equal to the tail of the
    whole stream."""
    if batch_rows < 1:
        raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
    R = packing.n_blocks
    n_batches = -(-R // batch_rows)
    for b in range(start, n_batches):
        idx = np.minimum(np.arange(b * batch_rows, (b + 1) * batch_rows), R - 1)
        x, y = _batch_of(packing, idx)
        tail = np.arange(batch_rows) + b * batch_rows >= R
        if tail.any():
            x["tokens"] = np.where(tail[:, None], packing.pad_id, x["tokens"])
            y["labels"] = np.where(tail[:, None], packing.pad_id, y["labels"])
            x["segment_ids"] = np.where(tail[:, None], 0, x["segment_ids"])
            x["positions"] = np.where(tail[:, None], 0, x["positions"])
            y["weights"] = np.where(tail[:, None], 0.0, y["weights"]).astype(np.float32)
        yield x, y


def padded_batches(
    docs: Sequence[Any], block_len: int, batch_rows: int, *, pad_id: int = 0,
    start: int = 0,
) -> Iterator[Tuple[Pytree, Pytree]]:
    """The padded layout of the same documents, one per ``[block_len]``
    row: ``x`` a plain ``[B, S]`` token array, ``y`` the same
    ``{"labels", "weights"}`` target as :func:`packed_batches`."""
    arrs = [np.asarray(d, np.int32).reshape(-1) for d in docs]
    n_batches = -(-len(arrs) // batch_rows)
    for b in range(start, n_batches):
        chunk = arrs[b * batch_rows:(b + 1) * batch_rows]
        tokens = np.full((batch_rows, block_len), pad_id, np.int32)
        labels = np.full((batch_rows, block_len), pad_id, np.int32)
        weights = np.zeros((batch_rows, block_len), np.float32)
        for r, a in enumerate(chunk):
            if a.size > block_len:
                raise ValueError(f"document has {a.size} tokens > block_len={block_len}")
            tokens[r, :a.size] = a
            labels[r, :a.size - 1] = a[1:]
            weights[r, :a.size - 1] = 1.0
        yield tokens, {"labels": labels, "weights": weights}


def real_token_fraction(x: Pytree, *, pad_id: int = 0) -> float:
    """Fraction of batch positions that hold real tokens: a packed batch
    counts non-zero segments; a ``[B, S]`` token array counts all but
    each row's trailing run of ``pad_id``."""
    if isinstance(x, dict) and "segment_ids" in x:
        seg = np.asarray(x["segment_ids"])
        return float(np.mean(seg != 0)) if seg.size else 0.0
    a = np.asarray(x)
    if a.ndim != 2 or a.size == 0:
        return 1.0
    rev = a[:, ::-1] != pad_id
    trailing = np.where(rev.any(axis=1), np.argmax(rev, axis=1), a.shape[1])
    return 1.0 - float(np.sum(trailing)) / a.size


def _to_device(item: Pytree, device: torch.device, stream: Any) -> Pytree:
    """``item``'s arrays as tensors on ``device``: on a CUDA device
    through pinned host memory, copied on ``stream``."""
    def move(a: Any) -> Any:
        if not isinstance(a, (np.ndarray, torch.Tensor)):
            return a
        t = torch.as_tensor(a)
        if device.type != "cuda":
            return t.to(device)
        with torch.cuda.stream(stream):
            return t.pin_memory().to(device, non_blocking=True)

    return pytree.tree_map(move, item)


def prefetch_to_device(
    iterable: Iterable[Pytree], size: int = 2, device: Any = None,
) -> Iterator[Pytree]:
    """Yield the batches of ``iterable`` (pytrees of numpy arrays or
    tensors) as tensors on ``device`` (``cuda`` unless named) with
    ``size`` transfers in flight.  On a card each copy runs from pinned
    memory on a side stream, and the consumer's stream waits for it
    before the batch is yielded, so batch ``k + 1``'s copy overlaps step
    ``k``.  The iterator runs at most ``size`` items ahead."""
    from torchgpipe_tpu_torch.models.transformer import resolve_device

    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    it = iter(iterable)
    queue: collections.deque = collections.deque()

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                item = next(it)
            except StopIteration:
                return
            moved = _to_device(item, dev, stream)
            done = None
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
            queue.append((moved, done))

    enqueue(size)
    while queue:
        item, done = queue.popleft()
        if done is not None:
            torch.cuda.current_stream(dev).wait_event(done)
            for t in pytree.tree_leaves(item):
                if isinstance(t, torch.Tensor):
                    t.record_stream(torch.cuda.current_stream(dev))
        yield item
        enqueue(1)


def pipe_data_sharding(pipe: Any, *, stacked: bool = False) -> torch.device:
    """Where a full training batch of ``pipe`` belongs, what
    :func:`prefetch_to_device`'s ``device`` should be: a ``GPipe``'s
    first stage's device (micro-batches enter there), a
    ``DistributedGPipe`` rank's own device.  ``stacked`` (megastep's
    ``[K, ...]`` batches) changes nothing for these: every dimension
    rides along."""
    from torchgpipe_tpu_torch.distributed.gpipe import DistributedGPipe
    from torchgpipe_tpu_torch.gpipe import GPipe
    from torchgpipe_tpu_torch.models.transformer import not_ported

    if isinstance(pipe, GPipe):
        return pipe.devices[0]
    if isinstance(pipe, DistributedGPipe):
        return pipe.device
    raise not_ported(f"pipe_data_sharding of {type(pipe).__name__} (SPMD)", "5.4")


def prefetch_to_pipe(
    iterable: Iterable[Pytree], pipe: Any, size: int = 2, *, stacked: bool = False,
) -> Iterator[Pytree]:
    """:func:`prefetch_to_device` onto :func:`pipe_data_sharding`'s
    device: each batch's copy overlaps the previous step::

        for x, y in prefetch_to_pipe(loader, pipe):
            loss, aux = step(x, y)
    """
    return prefetch_to_device(iterable, size, device=pipe_data_sharding(pipe, stacked=stacked))


def global_batch_from_local(mesh: Any, spec: Any, local_batch: Pytree) -> Pytree:
    """A global sharded batch from each process's shard: not ported yet."""
    from torchgpipe_tpu_torch.models.transformer import not_ported

    raise not_ported("utils.data.global_batch_from_local (multi-host SPMD)", "5.4")


__all__ = ["Packing", "global_batch_from_local", "pack_documents", "packed_batches",
           "padded_batches", "pipe_data_sharding", "prefetch_to_device",
           "prefetch_to_pipe", "real_token_fraction"]
