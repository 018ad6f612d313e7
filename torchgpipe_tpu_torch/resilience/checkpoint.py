"""Crash-safe, versioned checkpoints of numpy trees, in one process or
many.

Counterpart of :class:`CheckpointManager` in
``torchgpipe_tpu/resilience/checkpoint.py`` (``:148``), with the same
directory layout, manifest and CRCs, so that a snapshot either package
writes restores in the other (the serving engine's drain snapshot is the
case ``tests/test_torch_serving.py`` checks):

* **Atomic**: each snapshot is staged in a hidden temp directory in the
  same filesystem, every file fsync'd, the JSON manifest written LAST,
  and the directory renamed into place — a crash at any point leaves
  either the previous complete snapshot set or one invisible temp dir.
* **Verified**: the manifest records a CRC-32, shape and dtype per array;
  restore re-hashes and skips any snapshot that fails (truncation or
  corruption after the write included).
* **Versioned + GC'd**: snapshots live under ``step_<n>``;
  ``keep_last_k`` complete snapshots are kept.

The payload is a tree of nested dicts, lists and tuples whose leaves are
numpy arrays (or anything ``np.asarray`` takes), flattened to the names
``jax.tree_util.keystr`` gives them: ``['r1']['prompt']`` for nested dict
keys, ``[0]`` for sequence items, dict keys in sorted order.  This module
computes those names itself; it imports no JAX.

In a ``torch.distributed`` job every process calls :meth:`CheckpointManager.save`
and :meth:`CheckpointManager.restore_latest` with the same arguments.
The filesystem surgery (the temp directory, the manifest written last,
the renames, ``.old`` and GC) is rank 0's alone, fenced by barriers over
the job's default group at the reference's points (init, pre-save,
post-write, post-swap); no branch depends on a per-rank probe of the
filesystem.  The npz backend keeps the reference's meaning: rank 0
writes the tree it is passed.  ``sharded=True`` (the reference's orbax
backend) writes one file a rank under ``sharded/``, each rank's pieces
of a tree of :class:`~torchgpipe_tpu_torch.utils.serialization.Shard`
leaves (``SpmdGPipe.train_state``), and the manifest records a CRC-32 and
size per file; a restore needs the template of the tree it restores
into, and any file that fails verification makes the whole snapshot
fall back to the next older one.  Every rank takes the same snapshot: a
restore agrees on each candidate over the job (one all-reduce of a
flag).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from torchgpipe_tpu_torch.utils.serialization import _dist, barrier, read_shards, write_shards

Tree = Any

_FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_NPZ = "state.npz"
_SHARDED = "sharded"
_STEP_PREFIX = "step_"
_TMP_PREFIX = ".tmp-"


class CheckpointError(RuntimeError):
    """A checkpoint operation failed (bad arguments, no usable snapshot
    when one was required, ...)."""


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """A restored checkpoint: the payload tree, its step and metadata."""

    step: int
    tree: Tree
    metadata: Dict[str, Any]
    path: str


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _leaves(tree: Tree, path: str = "") -> List[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in ``jax.tree_util`` order: dict keys
    sorted, sequences in order, ``None`` an empty subtree."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, f"{path}[{i}]")
        return out
    if tree is None:
        return []
    return [(path or ".", tree)]


def _rebuild(template: Tree, leaves: List[Any]) -> Tree:
    """``template``'s structure with its leaves taken in order from
    ``leaves`` (consumed from the front, dict keys sorted; each dict keeps
    the template's own key order)."""
    if isinstance(template, dict):
        built = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: built[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    if template is None:
        return None
    return leaves.pop(0)


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    """Tree -> flat ``{keystr: host ndarray}``."""
    out: Dict[str, np.ndarray] = {}
    for key, leaf in _leaves(tree):
        if key in out:
            raise CheckpointError(f"duplicate tree key {key!r}")
        out[key] = np.asarray(leaf)
    return out


def _unflatten_like(template: Tree, flat: Dict[str, np.ndarray]) -> Tree:
    """Rebuild ``template``'s structure with leaves from ``flat``; strict
    (missing/extra keys and shape mismatches raise)."""
    remaining = dict(flat)
    leaves = []
    for key, leaf in _leaves(template):
        if key not in remaining:
            raise CheckpointError(f"checkpoint is missing key {key!r}")
        arr = remaining.pop(key)
        want = tuple(np.shape(leaf))
        if tuple(arr.shape) != want:
            raise CheckpointError(
                f"shape mismatch for {key!r}: saved {tuple(arr.shape)}, "
                f"template expects {want}"
            )
        leaves.append(arr.astype(np.asarray(leaf).dtype))
    if remaining:
        raise CheckpointError(
            f"unexpected keys in checkpoint: {sorted(remaining)[:5]}"
            + ("..." if len(remaining) > 5 else "")
        )
    return _rebuild(template, leaves)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without O_RDONLY dirs; durability best-effort
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _all_agree(ok: bool) -> bool:
    """Whether ``ok`` holds on every rank of the job (itself in one
    process)."""
    if _dist()[1] == 1:
        return ok
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    flag = torch.tensor([1.0 if ok else 0.0], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item() == 1.0)


class CheckpointManager:
    """Atomic, versioned, checksummed snapshots under one directory.
    In a multi-process job every process calls :meth:`save` and
    :meth:`restore_latest` with the same arguments (see the module
    doc)."""

    def __init__(self, directory: str, *, keep_last_k: int = 3) -> None:
        if keep_last_k < 1:
            raise ValueError("keep_last_k must be >= 1")
        self.directory = os.path.abspath(os.fspath(directory))
        self.keep_last_k = keep_last_k
        if _dist()[0] == 0:
            os.makedirs(self.directory, exist_ok=True)
        barrier()

    # ------------------------------------------------------------------ #
    # save                                                               #
    # ------------------------------------------------------------------ #

    def save(
        self,
        step: int,
        tree: Tree,
        *,
        metadata: Optional[Dict[str, Any]] = None,
        sharded: bool = False,
        world_size: Optional[int] = None,
        balance: Optional[List[int]] = None,
    ) -> str:
        """Write snapshot ``step_<step>`` atomically; returns its path.
        ``metadata`` must be JSON-serializable; arrays belong in ``tree``.
        ``world_size``/``balance`` record the stage count and layer cut the
        snapshot was taken under (in the manifest's metadata), so a
        restore into another world size is detected up front
        (:meth:`restore_latest` with ``world_size=``).  ``sharded=True``
        writes each rank's pieces of ``tree`` (leaves
        :class:`~torchgpipe_tpu_torch.utils.serialization.Shard` or whole
        arrays, which rank 0 writes) to its own file."""
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        final = self._step_dir(step)
        tmp = os.path.join(
            self.directory, f"{_TMP_PREFIX}{_STEP_PREFIX}{step:010d}"
        )
        meta = dict(metadata or {})
        if world_size is not None:
            meta["world_size"] = int(world_size)
        if balance is not None:
            meta["balance"] = [int(b) for b in balance]
        manifest: Dict[str, Any] = {
            "format": _FORMAT_VERSION,
            "step": int(step),
            "backend": _SHARDED if sharded else "npz",
            "metadata": meta,
        }
        rank = _dist()[0]
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(os.path.join(tmp, _SHARDED) if sharded else tmp)
        barrier()   # pre-save
        if sharded:
            write_shards(os.path.join(tmp, _SHARDED), tree)
            barrier()   # post-write
            if rank == 0:
                manifest["files"] = self._hash_dir(tmp)   # each file fsync'd by its writer
        else:
            flat = _flatten(tree)
            manifest["arrays"] = {
                k: {"crc32": _crc(a), "shape": list(a.shape), "dtype": str(a.dtype)}
                for k, a in flat.items()
            }
            if rank == 0:
                with open(os.path.join(tmp, _NPZ), "wb") as f:
                    np.savez(f, **flat)
                    f.flush()
                    os.fsync(f.fileno())
        if rank == 0:
            # Manifest LAST, then the tmp dir itself, then the swap: its
            # presence inside a step_* dir certifies a complete write.
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            if os.path.exists(final):
                old = final + ".old"
                shutil.rmtree(old, ignore_errors=True)
                os.rename(final, old)
                os.rename(tmp, final)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.rename(tmp, final)
            _fsync_dir(self.directory)
            self._gc()
        barrier()   # post-swap
        return final

    # ------------------------------------------------------------------ #
    # restore                                                            #
    # ------------------------------------------------------------------ #

    def restore_latest(self, template: Optional[Tree] = None, *,
                       world_size: Optional[int] = None) -> Optional[Snapshot]:
        """The newest snapshot that passes verification, or ``None``.
        Corrupt or partial snapshots are skipped in favor of the next
        older one.  With ``template`` the payload is rebuilt into its
        structure (required for a sharded snapshot: this rank's live tree
        of ``Shard`` leaves, or whole arrays for the gathered tree);
        without it the flat ``{keystr: ndarray}`` dict is returned.
        ``world_size=`` is the stage count the caller restores into: a
        snapshot recorded under another returns flat (its metadata holds
        the recorded ``balance``).  In a multi-process job every rank
        takes the same snapshot."""
        for step in self._candidates():
            use_template = template
            if world_size is not None and template is not None:
                recorded = self._recorded_world_size(step)
                if recorded is not None and recorded != int(world_size):
                    use_template = None
            snap = self._try_restore(step, use_template)
            if snap is not None:
                return snap
        return None

    def restore_step(
        self, step: int, template: Optional[Tree] = None
    ) -> Snapshot:
        """Restore one specific snapshot; raises if it fails verification."""
        snap = self._try_restore(step, template)
        if snap is None:
            raise CheckpointError(
                f"snapshot step_{step} at {self._step_dir(step)} is missing "
                "or fails verification"
            )
        return snap

    def steps(self) -> List[int]:
        """Steps with a snapshot directory present (verified or not),
        ``step_<n>.old`` included (a crash between the two renames of a
        same-step re-save leaves only that copy)."""
        return _scan_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------ #
    # internals                                                          #
    # ------------------------------------------------------------------ #

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{step:010d}")

    def _read_manifest(self, path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(os.path.join(path, _MANIFEST)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(manifest, dict) or manifest.get("format") != _FORMAT_VERSION:
            return None
        return manifest

    def _candidates(self) -> List[int]:
        """The steps to try, newest first: rank 0's listing, which every
        rank of a multi-process job then walks in the same order."""
        steps = sorted(self.steps(), reverse=True)
        if _dist()[1] > 1:
            box = [steps]
            dist.broadcast_object_list(box, src=0)
            steps = box[0]
        return steps

    def _recorded_world_size(self, step: int) -> Optional[int]:
        """The ``world_size`` snapshot ``step`` was taken under (``.old``
        fallback included), or ``None`` when unrecorded or unreadable."""
        primary = self._step_dir(step)
        for path in (primary, primary + ".old"):
            manifest = self._read_manifest(path)
            if manifest is not None:
                ws = manifest.get("metadata", {}).get("world_size")
                try:
                    return int(ws) if ws is not None else None
                except (TypeError, ValueError):
                    return None
        return None

    def _hash_dir(self, root: str, *,
                  only: Optional[List[str]] = None) -> Dict[str, Dict[str, int]]:
        """CRC-32 and size per file under ``root`` (the manifest
        excluded), by relative path: the sharded backend's integrity
        record.  ``only`` limits it to those paths."""
        out: Dict[str, Dict[str, int]] = {}
        for dirpath, _, filenames in os.walk(root):
            for fn in sorted(filenames):
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root)
                if fn == _MANIFEST or (only is not None and rel not in only):
                    continue
                crc = size = 0
                with open(full, "rb") as f:
                    while True:
                        chunk = f.read(1 << 22)
                        if not chunk:
                            break
                        crc = zlib.crc32(chunk, crc)
                        size += len(chunk)
                out[rel] = {"crc32": crc, "size": size}
        return out

    def _try_restore(
        self, step: int, template: Optional[Tree]
    ) -> Optional[Snapshot]:
        """Verify-and-load ``step``, falling back to ``step_<n>.old``.  In
        a multi-process job a copy is read only once every rank found it
        whole (a sharded snapshot: each rank hashing its share of the
        files), and counts only if every rank loaded it."""
        primary = self._step_dir(step)
        for path in (primary, primary + ".old"):
            manifest = self._read_manifest(path)
            if manifest is not None and manifest.get("backend") == _SHARDED \
                    and template is None:
                raise CheckpointError(
                    f"snapshot step_{step} is sharded: restore_latest needs the "
                    "template tree to supply its structure and this rank's "
                    "slices (SpmdGPipe.train_state)")
            if not _all_agree(manifest is not None and self._verified(path, manifest)):
                continue
            snap = self._load(path, step, template, manifest)
            if _all_agree(snap is not None):
                return snap
        return None

    def _verified(self, path: str, manifest: Dict[str, Any]) -> bool:
        """A sharded snapshot's files: those the manifest names, and this
        rank's share of them hashing to its record.  (An npz snapshot is
        verified array by array as it loads.)"""
        if manifest.get("backend") != _SHARDED:
            return True
        want = manifest.get("files")
        if not isinstance(want, dict):
            return False
        rank, world = _dist()
        names = sorted(want)
        present = {os.path.relpath(os.path.join(dirpath, fn), path)
                   for dirpath, _, filenames in os.walk(path)
                   for fn in filenames if fn != _MANIFEST}
        share = names[rank::world]
        return present == set(names) and \
            self._hash_dir(path, only=share) == {n: want[n] for n in share}

    def _load(
        self, path: str, step: int, template: Optional[Tree], manifest: Dict[str, Any]
    ) -> Optional[Snapshot]:
        metadata = manifest.get("metadata", {})
        if manifest.get("backend") == _SHARDED:
            try:
                tree = read_shards(os.path.join(path, _SHARDED), template)
            except Exception:  # noqa: BLE001 - unreadable file, missing piece
                return None
            return Snapshot(step=step, tree=tree, metadata=metadata, path=path)
        want_arrays = manifest.get("arrays")
        if not isinstance(want_arrays, dict):
            return None
        try:
            with np.load(os.path.join(path, _NPZ)) as f:
                flat = {k: f[k] for k in f.files}
        except Exception:  # noqa: BLE001 - truncated/corrupt zip, missing file
            return None
        if set(flat) != set(want_arrays):
            return None
        for k, rec in want_arrays.items():
            a = flat[k]
            if (
                list(a.shape) != rec.get("shape")
                or str(a.dtype) != rec.get("dtype")
                or _crc(a) != rec.get("crc32")
            ):
                return None
        tree = _unflatten_like(template, flat) if template is not None else flat
        return Snapshot(step=step, tree=tree, metadata=metadata, path=path)

    def _gc(self) -> None:
        """Keep the last ``keep_last_k`` COMPLETE snapshots; sweep
        ``step_<n>.old`` copies whose primary is complete again, and
        incomplete snapshot dirs older than a newer complete one."""
        complete = [
            s for s in self.steps()
            if self._read_manifest(self._step_dir(s)) is not None
        ]
        for s in complete[: -self.keep_last_k]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            shutil.rmtree(self._step_dir(s) + ".old", ignore_errors=True)
        for s in complete:
            shutil.rmtree(self._step_dir(s) + ".old", ignore_errors=True)
        newest = complete[-1] if complete else None
        cutoff = (
            complete[-self.keep_last_k]
            if len(complete) >= self.keep_last_k
            else None
        )
        for s in self.steps():
            if newest is not None and s < newest and s not in complete:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
            if cutoff is not None and s < cutoff:
                shutil.rmtree(self._step_dir(s) + ".old", ignore_errors=True)


def _scan_steps(directory: str) -> List[int]:
    """Step numbers present under ``directory`` (``step_<n>`` and
    ``step_<n>.old``), verified or not."""
    if not os.path.isdir(directory):
        return []
    out = set()
    for name in os.listdir(directory):
        if not name.startswith(_STEP_PREFIX):
            continue
        base = name[: -len(".old")] if name.endswith(".old") else name
        try:
            out.add(int(base[len(_STEP_PREFIX):]))
        except ValueError:
            continue
    return sorted(out)


def latest_step_or_none(directory: str) -> Optional[int]:
    """Peek at a checkpoint directory without constructing a manager, and
    so without its init barrier: any one rank may call it."""
    steps = _scan_steps(os.path.abspath(os.fspath(directory)))
    return steps[-1] if steps else None


__all__ = [
    "CheckpointError",
    "CheckpointManager",
    "Snapshot",
    "latest_step_or_none",
]
