"""Counter-based random keys for the pipeline's per-micro-batch RNG.

Counterpart of the reference's use of ``jax.random``: a key is folded
with the micro-batch index (``fold_in(rng, i)``) and then with the
layer's index in the whole model (``fold_in(rng_i, offset + li)``), and a
dropout draws its mask from the layer's key.  A mask is a pure function
of the key and the element index, so a checkpointed cell that
recomputes its forward, a 1F1B schedule and a replayed CUDA graph all
draw the same mask without saving any generator state.

The bits are not JAX's threefry: a key is a 32-bit value held in a 0-d
int64 tensor, and every mix is the ``lowbias32`` integer hash (two
xor-shift-multiply rounds) in plain tensor arithmetic, with each 32-bit
product split into 16-bit halves so no int64 product overflows.  It runs
on any device and inside a CUDA graph capture: a captured step reads
its key from a static input buffer and derives every mask on the
device, so a new key takes effect at the next replay.

:class:`Key` is lazy: folding records the path on the host, and the
tensor is computed only when a layer asks for it (:func:`layer_key`),
so a model without a random layer launches nothing for its keys.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

_M32 = 0xFFFFFFFF
_C1, _C2 = 0x7FEB352D, 0x846CA68B   # lowbias32's multipliers
_FOLD = 0x9E3779B9                   # decorrelates fold data from keys


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for ``0 <= x < 2^32`` in int64 without
    overflow: the 16-bit halves of ``x`` times ``c`` stay below 2^48."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _hash(x: torch.Tensor) -> torch.Tensor:
    """``lowbias32`` over int64 tensors holding 32-bit values (a
    bijection on ``[0, 2^32)``)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def _hash_int(x: int) -> int:
    """:func:`_hash` on a Python int."""
    x &= _M32
    x ^= x >> 16
    x = (x * _C1) & _M32
    x ^= x >> 15
    x = (x * _C2) & _M32
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """The 32-bit key value of an integer seed."""
    return _hash_int(_hash_int(seed & _M32) ^ (seed >> 32) & _M32)


def key_tensor(rng: Any) -> torch.Tensor:
    """A key as a 0-d int64 tensor: an int seed becomes a CPU tensor of
    :func:`seed_key`; an integer tensor is taken as a key value."""
    if isinstance(rng, torch.Tensor):
        if rng.dtype.is_floating_point or rng.numel() != 1:
            raise TypeError(f"an rng key is an int or a 1-element integer tensor, "
                            f"got {rng.dtype} of shape {tuple(rng.shape)}")
        return rng.reshape(()).to(torch.int64) & _M32
    if isinstance(rng, bool) or not isinstance(rng, int):
        raise TypeError(f"an rng key is an int or a 1-element integer tensor, "
                        f"got {type(rng).__name__}")
    return torch.tensor(seed_key(rng), dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A new key from ``key`` and an integer (the reference's
    ``jax.random.fold_in``)."""
    return _hash(key ^ _hash_int(data ^ _FOLD))


def bits(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """Uniform 32-bit values (int64) of ``shape`` from ``key``: element
    ``e`` (row-major) is ``hash(hash(e ^ key) + key)``.  The second
    round keeps two keys' streams unrelated where one first round
    would make them permutations of each other."""
    n = 1
    for s in shape:
        n *= s
    if n >= 1 << 32:
        raise ValueError(f"a random draw of {n} elements exceeds the 2^32 counter")
    e = torch.arange(n, dtype=torch.int64, device=key.device)
    return _hash((_hash(e ^ key) + key) & _M32).reshape(shape)


def bernoulli(key: torch.Tensor, p: float, shape: Tuple[int, ...]) -> torch.Tensor:
    """A bool mask of ``shape``, each element True with probability
    ``p`` (to 2^-32)."""
    return bits(key, shape) < int(round(p * (1 << 32)))


class Key:
    """A key and the path of integers folded into it, computed on
    demand (:meth:`value`) once per device."""

    __slots__ = ("base", "path", "_values")

    def __init__(self, base: torch.Tensor, path: Tuple[int, ...] = ()) -> None:
        self.base = base
        self.path = path
        self._values: Dict[torch.device, torch.Tensor] = {}

    def fold(self, data: int) -> "Key":
        return Key(self.base, self.path + (int(data),))

    def value(self, device: torch.device) -> torch.Tensor:
        if device not in self._values:
            k = self.base.to(device)
            for d in self.path:
                k = fold_in(k, d)
            self._values[device] = k
        return self._values[device]


class _Scope(threading.local):
    def __init__(self) -> None:
        self.key: Optional[Key] = None


_scope = _Scope()


@contextlib.contextmanager
def scope(key: Optional[Key]) -> Iterator[None]:
    """The key of the layer that runs inside (None: no key)."""
    prev = _scope.key
    _scope.key = key
    try:
        yield
    finally:
        _scope.key = prev


def layer_key(device: torch.device) -> Optional[torch.Tensor]:
    """The running layer's key on ``device``, or None outside a keyed
    pipeline cell."""
    key = _scope.key
    return None if key is None else key.value(device)
