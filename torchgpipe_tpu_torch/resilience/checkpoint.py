"""Crash-safe, versioned checkpoints of numpy trees, for one process.

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

Not ported (each raises, ROADMAP.md queue A item 5.4, sub-slice e): the orbax
``sharded=True`` backend, and more than one process (the reference
fences its filesystem surgery with cross-process barriers).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from torchgpipe_tpu_torch.models.transformer import not_ported

Tree = Any

_FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_NPZ = "state.npz"
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
    ``leaves`` (consumed from the front)."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
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


def _single_process(what: str) -> None:
    """Refuse a multi-process job: the reference's cross-process barriers
    are not ported."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise not_ported(f"multi-process checkpoints ({what})", "5.4")


class CheckpointManager:
    """Atomic, versioned, checksummed snapshots under one directory, for
    one process."""

    def __init__(self, directory: str, *, keep_last_k: int = 3) -> None:
        if keep_last_k < 1:
            raise ValueError("keep_last_k must be >= 1")
        _single_process("CheckpointManager")
        self.directory = os.path.abspath(os.fspath(directory))
        self.keep_last_k = keep_last_k
        os.makedirs(self.directory, exist_ok=True)

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
    ) -> str:
        """Write snapshot ``step_<step>`` atomically; returns its path.
        ``metadata`` must be JSON-serializable; arrays belong in ``tree``.
        (The reference's ``world_size``/``balance`` records serve its
        elastic ``Supervisor``, not ported yet.)"""
        if sharded:
            raise not_ported("orbax sharded checkpoints (sharded=True)", "5.4")
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        _single_process("save")
        final = self._step_dir(step)
        tmp = os.path.join(
            self.directory, f"{_TMP_PREFIX}{_STEP_PREFIX}{step:010d}"
        )
        meta = dict(metadata or {})
        flat = _flatten(tree)
        manifest: Dict[str, Any] = {
            "format": _FORMAT_VERSION,
            "step": int(step),
            "backend": "npz",
            "metadata": meta,
            "arrays": {
                k: {"crc32": _crc(a), "shape": list(a.shape), "dtype": str(a.dtype)}
                for k, a in flat.items()
            },
        }
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _NPZ), "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
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
        return final

    # ------------------------------------------------------------------ #
    # restore                                                            #
    # ------------------------------------------------------------------ #

    def restore_latest(self, template: Optional[Tree] = None) -> Optional[Snapshot]:
        """The newest snapshot that passes verification, or ``None``.
        Corrupt or partial snapshots are skipped in favor of the next
        older one.  With ``template`` the payload is rebuilt into its
        structure; without it the flat ``{keystr: ndarray}`` dict is
        returned."""
        for step in sorted(self.steps(), reverse=True):
            snap = self._try_restore(step, template)
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

    def _try_restore(
        self, step: int, template: Optional[Tree]
    ) -> Optional[Snapshot]:
        """Verify-and-load ``step``, falling back to ``step_<n>.old``."""
        primary = self._step_dir(step)
        snap = self._restore_dir(primary, step, template)
        if snap is not None:
            return snap
        return self._restore_dir(primary + ".old", step, template)

    def _restore_dir(
        self, path: str, step: int, template: Optional[Tree]
    ) -> Optional[Snapshot]:
        manifest = self._read_manifest(path)
        if manifest is None:
            return None
        if manifest.get("backend") != "npz":
            raise not_ported(
                f"snapshot step_{step} is an orbax sharded checkpoint", "5.4"
            )
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
        return Snapshot(step=step, tree=tree, metadata=manifest.get("metadata", {}),
                        path=path)

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
    """Peek at a checkpoint directory without constructing a manager."""
    steps = _scan_steps(os.path.abspath(os.fspath(directory)))
    return steps[-1] if steps else None


__all__ = [
    "CheckpointError",
    "CheckpointManager",
    "Snapshot",
    "latest_step_or_none",
]
