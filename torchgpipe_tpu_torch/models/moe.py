"""Mixture-of-experts feed-forward.

Counterpart of ``torchgpipe_tpu/models/moe.py`` (Switch/GShard top-k
routing, expert choice, megablocks-style dropless experts):

* **Routing** is a float32 softmax over experts (the router stays
  float32 in a bf16 model: routing is an argmax over near-ties), then an
  iterative-argmax top-k (:func:`_top_k_select`; ``torch.topk`` breaks
  ties another way) with a static per-expert capacity.  Tokens past an
  expert's capacity are dropped; the residual around the MLP carries
  them.
* **Dispatch** ``'dense'`` builds the one-hot ``[t, E, C]`` combine and
  dispatch tensors and runs einsums; ``'sparse'`` assigns slots by a
  stable sort and moves tokens by gather/scatter (the same FCFS slots);
  ``'auto'`` takes ``'sparse'`` past the reference's threshold
  (``t * E * C > 2**24``); ``'dropless'`` sorts the ``k * t`` assignments
  by expert and runs the expert SwiGLU as grouped products over the
  ragged segments, dropping nothing.  The reference's ``lax.ragged_dot``
  is XLA's, not a Pallas kernel: on the card the grouped products are
  ``torch._grouped_mm`` (bf16) with device-side int32 offsets, on the
  CPU a loop over experts.  Nothing on the card reads a device value to
  the host (counts come from ``scatter_add_``, not ``bincount``), so
  the Engine's programs stay capturable.
* ``router='expert_choice'``: each expert takes its top-``capacity``
  tokens (``lax.top_k``'s order: ties to the lower index).
* **Balance penalty** (``balance_weight > 0``): :func:`add_aux_grad`
  adds ``balance_weight * aux_scale`` to the penalty's gradient in the
  backward (``auxgrad.aux_scale`` is the pipeline's ``1/m``), so the
  optimizer follows ``task_loss + balance_weight *
  mean_over_microbatches(penalty)`` while the loss value stays the task
  loss.  :func:`router_stats` reports the same load, importance and
  penalty.

* **Expert parallelism** (``MoEConfig.ep_axis``): under
  ``torchgpipe_tpu_torch.spmd.SpmdGPipe(ep_axis=)`` each ep lane holds
  ``E/ep`` experts (``meta['param_specs']`` shards ``w_gate``/``w_up``/
  ``w_down`` on dim 0, the router replicated) and its own rows of the
  batch; the capacity paths' ``[E, C, d]`` buffers go to the lanes that
  own their experts by one all-to-all (``[E/ep, ep*C, d]``: split on the
  experts, concatenated on the slots) and come back by its inverse
  (``parallel.axes.all_to_all``), the capacity from the lane's own token
  count.  With the axis unbound (``init``, an oracle, ``generate``) the
  layer computes over every expert.  ``dropless`` and ``expert_choice``
  refuse an ep axis, as the reference's do.

Scatter-adds that would sum in an order set by atomics on the card are
written as a permutation and a sum over the ``k`` choices, so a step
repeats bit for bit (a captured Engine replay equals the eager step).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from torchgpipe_tpu_torch.auxgrad import current_aux_scale
from torchgpipe_tpu_torch.parallel.axes import all_to_all, axis_bound
from torchgpipe_tpu_torch.models.transformer import (
    Device,
    LMHead,
    Llama,
    TokenEmbedding,
    TransformerBlock,
    TransformerConfig,
    _init,
    _Layer,
    _normal,
    _param,
    resolve_device,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Expert-layer hyperparameters, the reference's fields.

    Token choice: ``capacity = max(1, ceil(capacity_factor * top_k * t /
    n_experts))`` per expert (``>= n_experts / top_k`` never drops);
    expert choice: ``min(t, max(1, ceil(capacity_factor * t /
    n_experts)))``.  ``balance_weight > 0`` trains the router against the
    Switch penalty ``E * sum(load * importance)``.  ``dispatch``:
    ``'auto'|'dense'|'sparse'|'dropless'``; ``router``:
    ``'topk'|'expert_choice'`` (expert choice ignores ``dispatch`` and
    ``top_k``, and needs ``balance_weight == 0``)."""

    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    ep_axis: Optional[str] = None
    balance_weight: float = 0.0
    dispatch: str = "auto"
    router: str = "topk"


def validate(moe: MoEConfig) -> None:
    """The reference's checks of ``moe_mlp``, its messages word for word."""
    E, K = moe.n_experts, moe.top_k
    if K > E:
        raise ValueError(f"top_k={K} exceeds n_experts={E}")
    if moe.dispatch not in ("auto", "dense", "sparse", "dropless"):
        raise ValueError(
            "MoEConfig.dispatch must be 'auto'|'dense'|'sparse'|'dropless'"
        )
    if moe.dispatch == "dropless" and moe.ep_axis is not None:
        raise ValueError(
            "dispatch='dropless' needs local experts (ep_axis=None): the "
            "ragged expert segments have data-dependent sizes, but the ep "
            "all_to_all exchanges static per-lane buffers — use the "
            "capacity paths ('auto'/'dense'/'sparse') with ep, or shard "
            "the expert weights over tp instead"
        )
    if moe.router not in ("topk", "expert_choice"):
        raise ValueError(
            "MoEConfig.router must be 'topk' or 'expert_choice'"
        )
    if moe.router == "expert_choice":
        if moe.ep_axis is not None:
            raise ValueError(
                "router='expert_choice' needs local experts "
                "(ep_axis=None): each expert selects its top-capacity "
                "tokens over the whole local batch, which with sharded "
                "experts would need a cross-lane token gather the "
                "capacity all_to_all does not provide"
            )
        if moe.balance_weight > 0.0:
            raise ValueError(
                "router='expert_choice' is perfectly balanced by "
                "construction (every expert takes exactly `capacity` "
                "tokens); set balance_weight=0"
            )


# --------------------------------------------------------------------- #
# the balance penalty's gradient                                        #
# --------------------------------------------------------------------- #


class _AuxInject(torch.autograd.Function):
    """Identity on ``y``; the backward hands ``aux`` the cotangent
    ``scaled`` (fixed when the forward ran), whatever reaches it."""

    @staticmethod
    def forward(ctx, y, aux, scaled):
        ctx.scaled = scaled
        ctx.aux = (aux.shape, aux.dtype, aux.device)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.aux
        return g, torch.full(shape, ctx.scaled, dtype=dtype, device=device), None


def add_aux_grad(y: torch.Tensor, aux: torch.Tensor, weight: float) -> torch.Tensor:
    """Identity on ``y`` whose backward adds ``weight * aux_scale`` to
    ``aux``'s cotangent (``aux_scale`` read now, when the forward runs:
    the pipeline sets it to ``1/m`` around every cell's forward and
    around a checkpointed cell's recompute).  Differentiating a loss
    ``L(y)`` seeded with 1 through it gives the gradients of ``L + weight
    * mean_over_microbatches(aux)``.  The product is taken in float32,
    as the reference's ``jnp.asarray(weight, float32) * scale``."""
    scaled = float(np.float32(weight) * np.float32(current_aux_scale()))
    return _AuxInject.apply(y, aux, scaled)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot`` as a comparison (no range check that would read
    the indices back to the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _balance_penalty(
    probs: torch.Tensor, n_experts: int, top_k: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Switch/GShard balance penalty from router probabilities ``[t, E]``:
    ``(load, importance, E * sum(load * importance))``, 1.0 iff perfectly
    balanced.  ``load`` counts the assignments of every top-k round,
    before capacity."""
    remaining = probs
    sel = probs.new_zeros((n_experts,), dtype=torch.float32)
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)
        mask = _one_hot(idx, n_experts, torch.float32)
        sel = sel + mask.mean(0)
        remaining = remaining * (1.0 - mask)
    load = sel / top_k
    importance = probs.mean(0)
    return load, importance, n_experts * (load * importance).sum()


# --------------------------------------------------------------------- #
# routing                                                               #
# --------------------------------------------------------------------- #


def _top_k_select(
    probs: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """Iterative-argmax top-k: per round the highest remaining expert
    (ties to the lower index) is chosen and masked out.  Returns the
    per-round expert indices ``[k, t]``, the one-hot masks (``k`` of
    ``[t, E]``) and the gates ``[k, t]`` (raw softmax probabilities)."""
    remaining = probs
    idxs, masks, gates = [], [], []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        mask = _one_hot(idx, probs.shape[-1], probs.dtype)
        idxs.append(idx)
        gates.append((probs * mask).sum(-1))
        masks.append(mask)
        remaining = remaining * (1.0 - mask)
    return torch.stack(idxs), masks, torch.stack(gates)


def _gate_denom(gates: torch.Tensor, k: int) -> torch.Tensor:
    """k > 1: the combine weights normalised over the k choices (GShard);
    k = 1 keeps the raw probability (Switch), so the router still learns."""
    return gates.sum(0) + 1e-9 if k > 1 else gates.new_ones(())


def _top_k_dispatch(
    probs: torch.Tensor, k: int, capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense ``combine [t, E, C]`` (gate weight at the token's slot, zero
    where dropped) and ``dispatch`` (its support).  Slots go first come
    first served in token order, round ``kk`` after round ``kk - 1``."""
    t, E = probs.shape
    _, masks, gates_kt = _top_k_select(probs, k)
    denom = _gate_denom(gates_kt, k)
    combine = probs.new_zeros((t, E, capacity))
    counts = probs.new_zeros((E,))
    slots = torch.arange(capacity, device=probs.device)
    for kk in range(k):
        mask = masks[kk]
        pos_in_e = torch.cumsum(mask, 0) - 1.0 + counts
        counts = counts + mask.sum(0)
        pos = (pos_in_e * mask).sum(-1).to(torch.int32)
        keep = (pos < capacity) & (mask.sum(-1) > 0)
        gate_k = torch.where(keep, gates_kt[kk] / denom, 0.0)
        slot = (pos[:, None] == slots).to(probs.dtype)      # jax.nn.one_hot
        combine = combine + mask[:, :, None] * slot[:, None, :] * gate_k[:, None, None]
    return combine, combine > 0.0


def _flat_assignment(
    probs: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sort-based paths' prologue: per-assignment arrays of length
    ``k * t`` in k-major order (assignment ``i`` is round ``i // t`` of
    token ``i % t``): ``experts`` (int32), ``gates`` (normalised),
    ``order`` (the stable expert sort) and ``counts [E]`` (int64, by
    ``scatter_add_``: no host read)."""
    idxs, _, gates_kt = _top_k_select(probs, k)
    denom = _gate_denom(gates_kt, k)
    experts = idxs.reshape(-1).to(torch.int32)
    gates = (gates_kt / denom).reshape(-1)
    order = torch.sort(experts, stable=True).indices
    e64 = experts.long()
    counts = torch.zeros(probs.shape[1], dtype=torch.int64,
                         device=probs.device).scatter_add_(0, e64, torch.ones_like(e64))
    return experts, gates, order, counts


def _sparse_assignment(
    probs: torch.Tensor, k: int, capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based slots with :func:`_top_k_dispatch`'s FCFS order:
    ``experts``, ``gates``, ``keep`` (False where the expert overflowed)
    and ``slot`` (int32, 0 where dropped), each of length ``k * t``."""
    kt = k * probs.shape[0]
    experts, gates, order, counts = _flat_assignment(probs, k)
    sorted_e = experts[order].long()
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = (torch.arange(kt, device=probs.device) - starts[sorted_e]).to(torch.int32)
    pos = torch.zeros(kt, dtype=torch.int32, device=probs.device).scatter_(
        0, order, pos_sorted)
    keep = pos < capacity
    slot = torch.where(keep, pos, 0)
    return experts, gates, keep, slot


def _dropless_assignment(
    probs: torch.Tensor, k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(order, tok_sorted, group_sizes, gates)``: the stable expert
    sort, the source token of each sorted row, the ragged segment lengths
    ``[E]`` (int32) and the gates in unsorted k-major order."""
    t = probs.shape[0]
    _, gates, order, counts = _flat_assignment(probs, k)
    tok = torch.arange(k * t, device=probs.device) % t
    return order, tok[order], counts.to(torch.int32), gates


# --------------------------------------------------------------------- #
# expert compute                                                        #
# --------------------------------------------------------------------- #


def _expert_ffn(expert_in: torch.Tensor, p: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Per-expert SwiGLU on ``[E, C, d]`` buffers (batched products)."""
    h = F.silu(torch.einsum("ecd,edh->ech", expert_in, p["w_gate"])) * \
        torch.einsum("ecd,edh->ech", expert_in, p["w_up"])
    return torch.einsum("ech,ehd->ecd", h, p["w_down"])


def _grouped_mm(x: torch.Tensor, w: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``lax.ragged_dot``: rows ``[starts[e], ends[e])`` of ``x [n, k]``
    times ``w[e] [k, m]``, for the ragged segments ``counts [E]``.  On
    the card: ``torch._grouped_mm`` with device offsets for bf16; another
    dtype takes every expert over every row and keeps its own segment
    (E times the work; no host read either).  On the CPU: a loop over
    the segments."""
    if x.device.type == "cuda":
        ends = torch.cumsum(counts, 0, dtype=torch.int32)
        if x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
            return torch._grouped_mm(x, w, offs=ends)
        rows = torch.arange(x.shape[0], device=x.device, dtype=torch.int32)[:, None]
        out = x.new_zeros((x.shape[0], w.shape[-1]))
        for e in range(w.shape[0]):
            inside = (rows >= ends[e] - counts[e]) & (rows < ends[e])
            out = torch.where(inside, x @ w[e], out)
        return out
    parts, start = [], 0
    for e, n in enumerate(counts.tolist()):
        parts.append(x[start:start + n] @ w[e])
        start += n
    return torch.cat(parts) if parts else x.new_zeros((0, w.shape[-1]))


def capacity_of(moe: MoEConfig, t: int) -> int:
    """The static per-expert budget for ``t`` tokens."""
    E = moe.n_experts
    if moe.router == "expert_choice":
        return min(t, max(1, math.ceil(moe.capacity_factor * t / E)))
    return max(1, math.ceil(moe.capacity_factor * moe.top_k * t / E))


def moe_forward(
    moe: MoEConfig, p: Mapping[str, torch.Tensor], x: torch.Tensor, *,
    train: bool = True,
) -> torch.Tensor:
    """The routed-expert SwiGLU of ``x [b, s, dim]`` with params
    ``router [dim, E]`` (float32), ``w_gate``/``w_up [E, dim, hidden]``,
    ``w_down [E, hidden, dim]``; returns ``x.dtype``.  With ``train``
    and ``balance_weight > 0``, the penalty's gradient is injected.
    Under a bound ``moe.ep_axis`` the expert leaves are this lane's
    ``E/ep`` experts and the capacity paths exchange their buffers with
    the other lanes (the reference's two all-to-alls)."""
    b, s, d = x.shape
    t = b * s
    E, K = moe.n_experts, moe.top_k
    xf = x.reshape(t, d)
    capacity = capacity_of(moe, t)
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)

    def finish(y: torch.Tensor) -> torch.Tensor:
        y = y.reshape(b, s, d).to(x.dtype)
        if moe.balance_weight > 0.0 and train:
            _, _, aux = _balance_penalty(probs, E, K)
            y = add_aux_grad(y, aux, moe.balance_weight)
        return y

    if moe.router == "expert_choice":
        vals, idx = torch.sort(probs.T, dim=-1, descending=True, stable=True)
        gates_ec, idx_ec = vals[:, :capacity], idx[:, :capacity]   # [E, C]
        out = _expert_ffn(xf[idx_ec], p)
        contrib = out * gates_ec[..., None].to(out.dtype)
        y = out.new_zeros((t, d))
        for e in range(E):     # an expert's tokens are distinct: no collision
            y = y.index_add(0, idx_ec[e], contrib[e])
        return finish(y)

    if moe.dispatch == "dropless":
        order, tok_sorted, group_sizes, gates = _dropless_assignment(probs, K)
        xs = xf[tok_sorted]
        h = F.silu(_grouped_mm(xs, p["w_gate"], group_sizes)) * \
            _grouped_mm(xs, p["w_up"], group_sizes)
        ys = _grouped_mm(h, p["w_down"], group_sizes)
        ys = ys * gates[order].to(ys.dtype)[:, None]
        # Un-sort (a permutation), then the k choices of each token.
        y = torch.zeros_like(ys).index_copy(0, order, ys)
        return finish(y.reshape(K, t, d).sum(0))

    use_sparse = moe.dispatch == "sparse" or (
        moe.dispatch == "auto" and t * E * capacity > 1 << 24)
    ep = axis_bound(moe.ep_axis)

    def experts_ffn(expert_in: torch.Tensor) -> torch.Tensor:
        # Under ep: [E, C, d] -> [E/ep, ep*C, d] to the lanes owning the
        # experts, the local experts' SwiGLU, and the inverse exchange.
        if ep is not None:
            expert_in = all_to_all(expert_in, ep, 0, 1)
        out = _expert_ffn(expert_in, p)
        return out if ep is None else all_to_all(out, ep, 1, 0)

    if use_sparse:
        experts, gates, keep, slot = _sparse_assignment(probs, K, capacity)
        tok = torch.arange(K * t, device=x.device) % t
        contrib = xf[tok] * keep[:, None].to(xf.dtype)
        e64, s64 = experts.long(), slot.long()
        expert_in = xf.new_zeros((E, capacity, d)).index_put(
            (e64, s64), contrib, accumulate=True)
        out = experts_ffn(expert_in)
        picked = out[e64, s64] * (gates * keep.to(gates.dtype))[:, None].to(out.dtype)
        return finish(picked.reshape(K, t, d).sum(0))
    combine, dispatch = _top_k_dispatch(probs, K, capacity)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(xf.dtype), xf)
    out = experts_ffn(expert_in)
    return finish(torch.einsum("tec,ecd->td", combine.to(out.dtype), out))


# --------------------------------------------------------------------- #
# modules                                                               #
# --------------------------------------------------------------------- #


class MoEMLP(_Layer):
    """The routed-expert feed-forward as a layer on ``[b, s, dim]``:
    ``router [dim, E]`` float32, ``w_gate``/``w_up [E, dim, hidden]``
    and ``w_down [E, hidden, dim]`` in ``cfg.dtype``.  Plug it into
    ``transformer_block(mlp=)``.  The injection of the balance penalty
    follows the module's ``training`` flag (the reference's ``train``).
    ``meta`` is the reference's: the ep axis, ``validate_mesh`` (the ep
    size must divide ``E``), the expert leaves' ``param_specs`` under an
    ep axis, the balance weight and the static ``moe`` record."""

    def __init__(self, cfg: TransformerConfig, moe: MoEConfig, *, device: Device = None,
                 name: str = "moe"):
        super().__init__()
        validate(moe)
        self.cfg, self.moe, self.name = cfg, moe, name
        dev = resolve_device(device)
        dim, hidden, E, dt = cfg.dim, cfg.mlp_hidden, moe.n_experts, cfg.dtype
        self.router = _param((dim, E), torch.float32, dev)
        # Routing is an argmax over near-ties: a mixed-precision policy
        # leaves the router float32 (precision.ComputeIn).
        self.router.keep_dtype = True
        self.w_gate = _param((E, dim, hidden), dt, dev)
        self.w_up = _param((E, dim, hidden), dt, dev)
        self.w_down = _param((E, hidden, dim), dt, dev)
        self.meta = _moe_meta(cfg, moe)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's distributions: ``N(0, dim^-1/2)`` router and
        ``w_gate``/``w_up``, ``N(0, hidden^-1/2)`` ``w_down``."""
        std, hstd = self.cfg.dim ** -0.5, self.cfg.mlp_hidden ** -0.5
        for name, t in self._parameters.items():
            s = hstd if name == "w_down" else std
            t.copy_(_normal(gen, t.shape, s, t.dtype, t.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_forward(self.moe, self.params(), x, train=self.training)


def _moe_meta(cfg: TransformerConfig, moe: MoEConfig) -> dict:
    """:class:`MoEMLP`'s ``meta`` (the reference's ``moe_mlp`` meta)."""
    from torchgpipe_tpu_torch.spmd import P

    E, ep = moe.n_experts, moe.ep_axis

    def validate_mesh(mesh: Any) -> None:
        if ep is None or ep not in mesh.axis_names:
            return
        size = mesh.shape[ep]
        if E % size != 0:
            raise ValueError(
                f"n_experts={E} is not divisible by the ep mesh axis size "
                f"{size}; expert parallelism places whole experts on lanes"
            )

    return {
        "kind": "moe_mlp", "balance_weight": moe.balance_weight, "ep_axis": ep,
        "validate_mesh": validate_mesh,
        "param_specs": None if ep is None else {
            "router": P(), "w_gate": P(ep), "w_up": P(ep), "w_down": P(ep)},
        "moe": {"n_experts": E, "top_k": moe.top_k,
                "capacity_factor": float(moe.capacity_factor), "dispatch": moe.dispatch,
                "router": moe.router, "ep_axis": ep, "dim": cfg.dim,
                "hidden": cfg.mlp_hidden, "itemsize": cfg.dtype.itemsize},
    }


def moe_mlp(
    cfg: TransformerConfig, moe: MoEConfig, *, device: Device = None,
    generator: Optional[torch.Generator] = None, name: str = "moe",
) -> MoEMLP:
    """A :class:`MoEMLP` initialised from ``generator``."""
    return _init(MoEMLP(cfg, moe, device=device, name=name), generator)


def router_stats(
    params_router: torch.Tensor, x: torch.Tensor, moe: MoEConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(load, importance, balance_loss)`` of hidden states ``[b, s,
    dim]``: per-expert assignment fractions over every top-k round,
    mean probabilities, and ``E * sum(load * importance)`` (1.0 is
    perfectly balanced).  Under expert choice every expert takes
    ``capacity`` tokens: load is uniform and the penalty exactly 1."""
    t = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(t, -1).float() @ params_router, dim=-1)
    if moe.router == "expert_choice":
        E = moe.n_experts
        load = probs.new_full((E,), 1.0 / E)
        return load, probs.mean(0), probs.new_tensor(1.0)
    return _balance_penalty(probs, moe.n_experts, moe.top_k)


def find_routers(params: Any) -> List[Any]:
    """Every router matrix of a model, depth first: a layer list or an
    ``nn.Module`` (its layers' ``params()`` dicts), or nested dicts and
    lists of tensors or arrays."""
    out: List[torch.Tensor] = []

    def walk(p: Any) -> None:
        if isinstance(p, nn.Module) and hasattr(p, "params"):
            p = p.params()
        elif isinstance(p, nn.Module):
            p = list(p.children())
        if isinstance(p, Mapping):
            r = p.get("router")
            if r is not None and hasattr(r, "shape"):
                out.append(r)
            for v in p.values():
                walk(v)
        elif isinstance(p, (list, tuple)):
            for v in p:
                walk(v)

    walk(params)
    return out


def moe_transformer_block(
    cfg: TransformerConfig, moe: MoEConfig, *, device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> TransformerBlock:
    """A pre-norm block with the routed-expert feed-forward in its MLP
    slot (its params under ``"mlp"``)."""
    dev = resolve_device(device)
    return _init(TransformerBlock(cfg, device=dev, mlp=MoEMLP(cfg, moe, device=dev)),
                 generator)


def llama_moe(
    cfg: TransformerConfig, moe: MoEConfig, *, device: Device = None,
    generator: Optional[torch.Generator] = None,
) -> Llama:
    """``[embed, moe_block_0 .. moe_block_{n-1}, head]``: the flat
    Mixtral-style model (every block MoE) that ``GPipe`` trains and
    ``generate(moe=)`` decodes."""
    if cfg.tie_embeddings:
        raise ValueError(
            "tie_embeddings is an SPMD-engine feature (same constraint "
            "as models.transformer.llama): the MPMD layer list places "
            "the embedding and the head on different stage devices.  Use "
            "llama_moe_spmd(cfg, moe, n) + SpmdGPipe, or set "
            "tie_embeddings=False"
        )
    validate(moe)
    return _init(Llama(cfg, device=device, mlp=lambda dev: MoEMLP(cfg, moe, device=dev)),
                 generator)


def llama_moe_spmd(
    cfg: TransformerConfig, moe: MoEConfig, n_stages: int, *,
    gather_logits: bool = True, device: Device = None,
) -> Tuple[nn.Sequential, TokenEmbedding, LMHead]:
    """``(block, pre, post)`` for ``torchgpipe_tpu_torch.spmd.SpmdGPipe``:
    each stage runs ``n_layers // n_stages`` MoE blocks (an
    ``nn.Sequential`` named ``stage``, blocks ``b0 ..``), ``pre`` the
    embedding and ``post`` the head, as
    :func:`~torchgpipe_tpu_torch.models.transformer.llama_spmd` builds
    them (``gather_logits`` as there; a tied head names ``tie_pre``).
    Under ``moe.ep_axis`` pass the same axis as ``SpmdGPipe(ep_axis=)``."""
    from torchgpipe_tpu_torch.models.transformer import spmd_ends

    if cfg.n_layers % n_stages != 0:
        raise ValueError(
            f"n_layers={cfg.n_layers} must divide evenly into {n_stages} stages"
        )
    validate(moe)
    dev = resolve_device(device)
    block = nn.Sequential(*[TransformerBlock(cfg, device=dev, mlp=MoEMLP(cfg, moe, device=dev))
                            for _ in range(cfg.n_layers // n_stages)])
    block.name = "stage"
    for i, layer in enumerate(block):
        layer.name = f"b{i}"
    return (block, *spmd_ends(cfg, gather_logits, dev))


__all__ = [
    "MoEConfig",
    "MoEMLP",
    "add_aux_grad",
    "find_routers",
    "llama_moe",
    "llama_moe_spmd",
    "moe_forward",
    "moe_mlp",
    "moe_transformer_block",
    "router_stats",
]
