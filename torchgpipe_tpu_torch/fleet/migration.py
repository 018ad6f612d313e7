"""Cross-pool KV migration: the handoff of phase-disaggregated serving.

Counterpart of ``torchgpipe_tpu/fleet/migration.py``.  DistServe/
Splitwise split the serving fleet by phase, so a request LIVES on two
replicas: it prefills (and emits its first token) on a prefill replica,
then its KV rows + frontier ship to a decode replica that continues the
stream.

* **Exact** — a slot's prefill writes are replica-independent, so the
  decode replica's greedy continuation equals a unified run's token for
  token on the same weights.
* **Fixed-shape** — the payload is one slot's per-layer KV rows (+ int8
  scale rows) with the slot axis sliced away
  (:meth:`~torchgpipe_tpu_torch.serving.engine.Engine.export_kv_rows`),
  and the decode engine writes them through its one ``migrate_ingest``
  program: the rows are copied into that program's static row buffers
  and ``dst``/``n`` live in a device tensor, so EVERY migration replays
  one captured graph.
* **Two transports, one program** — replicas in one process (on one
  card here) hand the donor's device views straight to the ingest,
  device to device; :func:`stage_rows` materialises the same tree on
  the host, the one place a handoff between cards or processes would
  stage.  The ingest cannot tell the difference.

Failure stays safe by ORDER: the ingest completes before
:meth:`complete_migration` frees the donor slot — an ingest that raises
(e.g. decode pool full) leaves the donor intact for the router to
re-park and retry.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from torchgpipe_tpu_torch.serving.engine import Engine
from torchgpipe_tpu_torch.serving.scheduler import Request


class MigrationError(RuntimeError):
    """A KV migration handoff could not be performed."""


def _flat_specs(specs: Dict[str, Any]) -> List[Tuple[str, int, Any, str]]:
    return [
        (name, i, tuple(s.shape), str(s.dtype))
        for name, leaves in sorted(specs.items())
        for i, s in enumerate(leaves)
    ]


def validate_pools(src: Engine, dst: Engine) -> None:
    """Didactic compatibility check between a prefill and a decode
    engine: roles correct, equal ``max_len``, and bit-identical per-slot
    KV row signatures (same cfg, same ``kv_quant``/dtype) — the rows one
    exports must be exactly what the other's ingest program expects.
    The router runs this once per prefill×decode pair at construction,
    so an incompatible fleet fails at build time, not mid-handoff."""
    if src.role != "prefill":
        raise MigrationError(
            f"migration source must be a prefill-role engine, got "
            f"role={src.role!r}"
        )
    if dst.role != "decode":
        raise MigrationError(
            f"migration target must be a decode-role engine, got "
            f"role={dst.role!r}"
        )
    if src.pool.max_len != dst.pool.max_len:
        raise MigrationError(
            f"pool max_len differs across roles ({src.pool.max_len} vs "
            f"{dst.pool.max_len}) — a migrated slot's rows must land at "
            "the same positions, so a disaggregated fleet needs equal "
            "max_len everywhere"
        )
    a, b = _flat_specs(src.kv_row_specs()), _flat_specs(dst.kv_row_specs())
    if a != b:
        diff = next(
            (f"{x} vs {y}" for x, y in zip(a, b) if x != y),
            f"{len(a)} vs {len(b)} row leaves",
        )
        raise MigrationError(
            "prefill/decode pools are migration-incompatible: per-slot "
            f"KV row specs differ ({diff}) — build both roles with the "
            "same cfg, max_len, kv_quant and cache dtype"
        )


def stage_rows(rows: Dict[str, Any]) -> Dict[str, Any]:
    """Materialise a migration payload as host tensors (copies, in the
    rows' own dtype: bfloat16 has no numpy twin) — the transport between
    cards or processes.  Replicas on one device skip this and hand the
    donor's device views to the ingest; the staged tree has identical
    structure, shapes and bits, so one ingest program serves both."""
    return {
        name: [x.detach().to("cpu", copy=True) for x in leaves]
        for name, leaves in rows.items()
    }


def migrate(
    src: Engine,
    dst: Engine,
    req: Request,
    *,
    on_token: Optional[Callable[[str, int], None]] = None,
    stage_host: bool = False,
) -> str:
    """Hand ONE migration-parked request from ``src`` to ``dst``.

    ``req`` must come from :meth:`Engine.take_migration_ready` (status
    ``'migrating'``, exactly one emitted token — the first token samples
    on the prefill replica so prefill and decode share one sampling-site
    semantics).  ``on_token`` replaces the request's callback on the
    decode side (the router re-wires its recording callback here);
    ``stage_host=True`` forces the drain-schema transport even in
    process.  Raises ``RuntimeError`` when ``dst`` has no free slot —
    the donor is left intact for a retry.  Returns the rid."""
    if req.status != "migrating":
        raise MigrationError(
            f"request {req.rid!r} is {req.status!r}, not parked for "
            "migration — only take_migration_ready() output migrates"
        )
    if len(req.generated) != 1:
        raise MigrationError(
            f"request {req.rid!r} carries {len(req.generated)} emitted "
            "tokens; a prefill engine parks at exactly one"
        )
    rows = src.export_kv_rows(req)
    if stage_host:
        rows = stage_rows(rows)
    dst.ingest_migration(
        rid=req.rid,
        prompt=req.prompt,
        max_new_tokens=req.max_new_tokens,
        rows=rows,
        last_token=req.generated[-1],
        eos_id=req.eos_id,
        on_token=on_token if on_token is not None else req.on_token,
        emitted_prefix=req.emitted_prefix,
    )
    # Ingest succeeded (its rows are copied into the decode pool's
    # buffers, in stream order before any later write to the donor
    # slot) — only now may the donor slot go.
    src.complete_migration(req)
    return req.rid


__all__ = ["MigrationError", "migrate", "stage_rows", "validate_pools"]
