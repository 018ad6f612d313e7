"""The serving engine's weight-swap certificate.

Counterpart of ``certify_swap`` in ``torchgpipe_tpu/analysis/
serving.py`` (``:410``).  The port's serving programs are CUDA graphs
captured over the engine's parameter tensors, so a swap writes new
values into those tensors (:meth:`~torchgpipe_tpu_torch.serving.engine.
Engine.swap_params`) and is capture-free iff every parameter of the
published version keeps the serving one's (name, shape, dtype, device).
:func:`certify_swap` proves that before anything changes; the rolling
rollout (:mod:`~torchgpipe_tpu_torch.fleet.rollout`) refuses a publish
it rejects.

The rest of the reference module — ``certify_ladder``,
``certify_speculative``, ``certify_disagg`` and ``lint_serving`` — is
ROADMAP.md queue A item 5.6; each name here raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

from typing import Any, List, Tuple

from torchgpipe_tpu_torch.analysis.diagnostics import Finding, Severity
from torchgpipe_tpu_torch.models.generation import _split_params
from torchgpipe_tpu_torch.models.transformer import not_ported


def _signature(cfg: Any, model: Any) -> List[Tuple[str, Tuple[int, ...], str, str]]:
    """``(path, shape, dtype, device type)`` of every parameter of
    ``model`` (the flat ``llama(cfg)`` layer list), layer by layer."""
    from torchgpipe_tpu_torch.serving.engine import _flat

    embed, blocks, head = _split_params(cfg, model)
    names = ["embed"] + [f"block{i}" for i in range(len(blocks))] + ["head"]
    return [
        (f"{name}.{k}", tuple(t.shape), str(t.dtype), t.device.type)
        for name, p in zip(names, [embed, *blocks, head])
        for k, t in _flat(p)
    ]


def certify_swap(engine: Any, new_params: Any) -> List[Finding]:
    """Statically certify a live param swap (``Engine.swap_params``, the
    rolling-rollout path).  A signature mismatch is an ERROR naming the
    first mismatching parameter (the engine would refuse the swap: it
    would have to recapture every program mid-serve); a match is one
    INFO finding with the certified parameter count.  A published model
    with the wrong layer count is an ERROR too."""
    findings: List[Finding] = []
    old_sig = _signature(engine.cfg, engine.serving_layers())
    try:
        new_sig = _signature(engine.cfg, list(new_params))
    except ValueError as err:
        new_sig, detail = None, str(err)
    if new_sig is not None and old_sig == new_sig:
        findings.append(Finding(
            rule="swap-bound",
            severity=Severity.INFO,
            path="serving/engine",
            message=(
                f"param swap certified capture-free: {len(old_sig)} "
                "parameters keep their (name, shape, dtype, device) "
                "signatures — KV pool and captured programs untouched"
            ),
        ))
        return findings
    if new_sig is not None:
        detail = f"parameter count {len(old_sig)} vs {len(new_sig)}"
        for old, new in zip(old_sig, new_sig):
            if old != new:
                detail = f"{old[0]}: serving {old[1:]} vs published {new[1:]}"
                break
    findings.append(Finding(
        rule="swap-bound",
        severity=Severity.ERROR,
        path="serving/engine",
        message=(
            "published params change the serving parameter signature "
            f"({detail}) — an in-place swap would have to recapture every "
            "program mid-serve; refused (cold-start a fresh engine for a "
            "re-shaped model)"
        ),
    ))
    return findings


def certify_ladder(engine: Any) -> List[Finding]:
    raise not_ported("analysis.serving.certify_ladder", "5.6")


def certify_speculative(engine: Any) -> List[Finding]:
    raise not_ported("analysis.serving.certify_speculative", "5.6")


def certify_disagg(prefill_engine: Any, decode_engine: Any) -> List[Finding]:
    raise not_ported("analysis.serving.certify_disagg", "5.6")


def lint_serving(engine: Any, grid: Any = None) -> List[Finding]:
    raise not_ported("analysis.serving.lint_serving", "5.6")


__all__ = ["certify_disagg", "certify_ladder", "certify_speculative",
           "certify_swap", "lint_serving"]
