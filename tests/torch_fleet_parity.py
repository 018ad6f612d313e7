"""Helpers shared by the fleet parity tests (``test_torch_fleet.py``,
``test_torch_disagg.py``, ``test_torch_obs_serving.py``): the reference
tests' tiny float32 Llama built by the reference and converted with
``params_from_jax``, the same engine configuration on both sides, and
seeded workloads.

Greedy streams are compared token for token: both sides compute the same
float32 network in another summation order (~1e-6 relative on the
logits), which flips an argmax only at a near-tie these seeded traces do
not have.
"""

import jax
import jax.numpy as jnp
import numpy as np

from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.serving import Engine as JEngine
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.serving import Engine

KW = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2)
DRAFT_KW = dict(vocab=64, dim=16, n_layers=1, n_heads=2, n_kv_heads=2)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)
JDRAFT, TDRAFT = jt.TransformerConfig(**DRAFT_KW), tt.TransformerConfig(**DRAFT_KW)


def weights(seed, jcfg=JCFG, tcfg=TCFG):
    """``(reference flat params, port model)`` from one reference init."""
    params, _, _ = sequential_init(
        jt.llama(jcfg), jax.random.PRNGKey(seed),
        jax.ShapeDtypeStruct((2, 8), jnp.int32),
    )
    model = params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return params, model


def engine_kw(kw):
    kw = dict(kw)
    kw.setdefault("num_slots", 4)
    kw.setdefault("max_len", 32)
    kw.setdefault("prefill_chunk", 8)
    return kw


def jengine(params, **kw):
    return JEngine(JCFG, params, **engine_kw(kw))


def tengine(model, **kw):
    return Engine(TCFG, model, device="cpu", **engine_kw(kw))


def shared_prefix_workload(seed, n, prefix_len=8, vocab=64):
    """n requests all opening with one tenant system prompt (the
    reference tests' ``_shared_prefix_workload``)."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, (prefix_len,)).astype(np.int32)
    out = []
    for _ in range(n):
        suffix = rng.randint(0, vocab, (int(rng.randint(1, 5)),)).astype(np.int32)
        out.append((np.concatenate([prefix, suffix]), int(rng.randint(2, 6))))
    return out


class Clock:
    """A hand-stepped clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class TickClock:
    """A clock that advances one second per read: deterministic stamps
    when both packages read it at the same points."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def counters(registry):
    """The counter and gauge series of a registry snapshot (histograms,
    whose reservoirs hold clock readings, left out)."""
    snap = registry.snapshot()
    return {k: v for k, v in snap.items()
            if not (isinstance(v, dict) and ("p50" in v or any(
                isinstance(x, dict) for x in v.values())))}
