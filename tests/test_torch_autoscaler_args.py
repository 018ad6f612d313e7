"""``fleet.Autoscaler``'s constructor against the reference's.

The port's ``Autoscaler`` takes every keyword the reference's takes, in
the reference's order and with its defaults, and stores
``tokens_per_request`` as the reference does (``int``).  Only the
reference's ``CostModel`` price reads it; that pricing (``cost_model=``,
``pipe=``) is ROADMAP queue A item 5.6 and still raises in the port.
"""

import inspect

import pytest

from torchgpipe_tpu import fleet as jfleet
from torchgpipe_tpu.obs import MetricsRegistry as JRegistry
from torchgpipe_tpu_torch import fleet
from torchgpipe_tpu_torch.obs import MetricsRegistry


class _Engine:
    """The least an engine shows the router and the autoscaler."""

    def __init__(self):
        self.role = "unified"
        self.drain_hooks = []
        self.pool = type("P", (), {"num_slots": 1, "num_free": 1, "max_len": 32})()
        self.scheduler = type("S", (), {"queue": [], "active": {}, "idle": True})()
        self.migration_pending = False

    def drain(self):
        return {"tree": {}, "requests": {}}

    def resume_serving(self):
        pass

    def kv_row_specs(self):
        return {}


def _params(cls):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(cls.__init__).parameters.values()]


def test_autoscaler_signature_matches_reference():
    assert _params(fleet.Autoscaler) == _params(jfleet.Autoscaler)


@pytest.mark.parametrize("value,want", [(None, 8), (16, 16), (3.0, 3), ("5", 5)])
def test_tokens_per_request_is_stored_as_the_reference_stores_it(value, want):
    kw = {} if value is None else {"tokens_per_request": value}
    got = fleet.Autoscaler(fleet.Router({"r0": _Engine()}, registry=MetricsRegistry()),
                           service_time_s=0.05, **kw)
    ref = jfleet.Autoscaler(jfleet.Router({"r0": _Engine()}, registry=JRegistry()),
                            service_time_s=0.05, **kw)
    assert type(got.tokens_per_request) is int
    assert got.tokens_per_request == ref.tokens_per_request == want
