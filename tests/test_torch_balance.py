"""torchgpipe_tpu_torch's automatic balancing against the JAX reference.

``blockpartition.solve``/``solve_sizes`` equal the reference's (its
native C++ solver where it builds, its Python DP otherwise) on random
sequences, errors included; ``balance_by_flops`` gives the reference's
balance on the tiny Llama of tests/test_torch_gpipe.py and a tiny ResNet;
``balance_by_time`` and ``balance_by_size`` keep the reference's
contracts (tests/test_balance.py) and leave the caller's model as it
was.

Counting.  The port counts FLOPs with ``FlopCounterMode`` over the
layers' forward and backward on the meta device; the reference walks the
jaxpr.  They agree on dense layers and stride-1 convolutions.  The
reference's walker counts the input gradient of a stride-s convolution as
a convolution over the s-dilated input (s^2 times the multiply-adds that
are not by inserted zeros), and attention's backward slightly otherwise;
the balances asked for here come out equal all the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.balance import balance_cost as jbalance_cost
from torchgpipe_tpu.balance import layer_flops as jlayer_flops
from torchgpipe_tpu.balance import blockpartition as jbp
from torchgpipe_tpu.models import resnet as jresnet
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch.balance import (
    balance_by_flops,
    balance_by_size,
    balance_by_time,
    balance_cost,
    layer_flops,
)
from torchgpipe_tpu_torch.balance import blockpartition as tbp
from torchgpipe_tpu_torch.batchnorm import convert_deferred_batch_norm
from torchgpipe_tpu_torch.models import resnet as tresnet
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops import nn as tnn

KW = dict(vocab=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1)


@pytest.mark.parametrize("seed", range(4))
def test_solve_matches_jax_on_random_sequences(seed):
    rs = np.random.RandomState(seed)
    for _ in range(20):
        n = rs.randint(1, 40)
        k = rs.randint(1, n + 1)
        costs = (rs.rand(n) * rs.choice([1, 10, 1000])).tolist()
        if seed == 3:                      # ties: integer costs
            costs = rs.randint(0, 4, n).tolist()
        assert tbp.solve(costs, k) == jbp.solve(costs, k), (costs, k)
        assert tbp.solve_sizes(costs, k) == jbp.solve_sizes(costs, k)


def test_solve_reference_cases():
    assert tbp.solve([1, 2, 3, 4, 5, 6], partitions=2) == [[1, 2, 3, 4], [5, 6]]
    assert max(sum(b) for b in tbp.solve([10, 1, 1, 1, 1, 10], 3)) == 10
    assert tbp.solve_sizes([5, 5, 5], 3) == [1, 1, 1]
    assert balance_cost([1, 1, 4, 1, 1], 2) in ([3, 2], [2, 3])


@pytest.mark.parametrize("args", [([1.0, 2.0], 3), ([1.0], 0)])
def test_solve_errors_match_jax(args):
    with pytest.raises(ValueError) as te:
        tbp.solve(*args)
    with pytest.raises(ValueError) as je:
        jbp.solve(*args)
    assert str(te.value) == str(je.value)


def test_balance_by_flops_matches_jax_on_the_tiny_llama():
    tl = list(tt.llama(tt.TransformerConfig(**KW), device="cpu"))
    jl = jt.llama(jt.TransformerConfig(**KW))
    flops = layer_flops(tl, torch.zeros(5, 16, dtype=torch.long))
    assert flops[0] == 0.0 and flops[1] == flops[2] > flops[3] > 0
    # balance_by_flops is balance_cost over layer_flops on both sides.
    jflops = jlayer_flops(jl, jax.ShapeDtypeStruct((5, 16), jnp.int32))
    for k in (1, 2, 3, 4):
        assert balance_by_flops(k, tl, torch.zeros(5, 16, dtype=torch.long)) == \
            jbalance_cost(jflops, k)


def test_balance_by_flops_matches_jax_on_a_tiny_resnet():
    tl = convert_deferred_batch_norm(
        list(tresnet.build_resnet([1, 1, 1, 1], 10, base_width=4, device="cpu")), 2)
    jl = jresnet.build_resnet([1, 1, 1, 1], 10, base_width=4)
    before = {k: v.clone() for layer in tl for k, v in layer.state_dict().items()}
    sample = torch.zeros(4, 3, 32, 32)
    flops = layer_flops(tl, sample)
    names = [layer.name for layer in tl]
    # Dense layers and stride-1 convolutions count as the reference counts.
    for name, want in (("layer1_b1_conv1", 24576.0), ("layer1_b1_conv2", 221184.0),
                       ("fc", 30720.0), ("bn1", 0.0), ("maxpool", 0.0)):
        assert flops[names.index(name)] == want, name
    jflops = jlayer_flops(jl, jax.ShapeDtypeStruct((4, 32, 32, 3), jnp.float32))
    for k in (2, 3, 4):
        assert balance_cost(flops, k) == jbalance_cost(jflops, k)
    assert balance_by_flops(3, tl, sample) == balance_cost(flops, 3)
    # Counting ran on meta copies: the model's tensors and counters are
    # as they were, and no gradient was left behind.
    after = {k: v for layer in tl for k, v in layer.state_dict().items()}
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(p.grad is None for layer in tl for p in layer.parameters())
    assert tl[1]._tracked == 0 and tl[1].mean.device.type == "cpu"


def _model():
    """tests/test_balance.py's model: two fat dense layers among thin ones."""
    kw = dict(device="cpu")
    return [
        tnn.Dense(512, 512, name="fat0", **kw), tnn.ReLU("r0"),
        tnn.Dense(512, 8, name="thin", **kw), tnn.Dense(8, 512, name="fat1", **kw),
        tnn.ReLU("r1"), tnn.Dense(512, 8, name="out", **kw),
    ]


def test_balance_by_time_contract():
    layers = _model() + [tnn.BatchNorm(8, name="bn", device="cpu")]
    before = layers[-1].mean.clone()
    balance = balance_by_time(2, layers, torch.ones(16, 512), timeout=0.2,
                              device="cpu")
    assert len(balance) == 2 and sum(balance) == len(layers)
    assert all(b > 0 for b in balance)
    # Profiled in sandboxes: no running statistic moved, no grad left.
    assert torch.equal(layers[-1].mean, before)
    assert all(p.grad is None for layer in layers for p in layer.parameters())


def test_balance_by_size_contract():
    layers = _model()
    with pytest.warns(UserWarning, match="coarse output-shape accounting"):
        balance = balance_by_size(2, layers, torch.ones(16, 512), device="cpu")
    assert len(balance) == 2 and sum(balance) == len(layers)
    # The two fat dense layers dominate memory and must not share a stage.
    assert balance[0] <= 3, f"unexpected balance {balance}"


def test_profiles_need_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (balance_by_time, balance_by_size):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(2, _model(), torch.ones(4, 512))
