"""``checkpoint='offload'`` against the JAX reference and against
``'never'``.

``'offload'`` is the ``'never'`` schedule (no cell recomputes: stop 0,
as the reference's ``checkpoint_stop`` says) with each cell's saved
tensors moved to pinned host memory after its forward and fetched back
one cell ahead of its backward.  On a CPU stage the move is skipped, as
in the reference (its memory is host memory already), so the CPU runs
here hold the schedule and the saved-tensor hooks: loss, gradients and
buffers bitwise those of ``'never'`` (a Llama and a convolutional model
with a skip across stages), the refusals word for word, and the bytes
the hooks take.  The card moves those bytes (tests/test_torch_cuda_training.py,
chip_smoke.py phase 14).

The reference's ``test_offload_memory_relocation_machinery`` fails on
jax 0.9.0, so the bytes are held to a formula: in a stack of dense
layers and ReLUs, each ReLU saves its output, the dense layer after it
saves the same tensor as its input, and a dense layer's weight and each
cell's input stay on the device; so a cell hands over one ReLU output
per ReLU, ``rows x width x 4`` bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu import checkpoint as jckpt
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch import checkpoint as tckpt
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops import nn as tnn
from tests.test_torch_fused import _data, _jax_layers, _state, _torch_layers
from tests.torch_parity import nchw, torch_mean_loss

KW = dict(vocab=256, dim=128, n_layers=2, n_heads=2, n_kv_heads=1)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)


@pytest.mark.parametrize("chunks", [1, 3, 8])
@pytest.mark.parametrize("train", [True, False])
def test_offload_stop_matches_jax(chunks, train):
    assert tckpt.checkpoint_stop("offload", chunks, train=train) == \
        jckpt.checkpoint_stop("offload", chunks, train=train) == 0


@pytest.mark.parametrize("kwargs", [
    {"fused": True},
    {"schedule": "1f1b", "loss_reduction": "sum"},
])
def test_offload_refusals_match_jax(kwargs):
    with pytest.raises(ValueError) as je:
        JGPipe(_jax_layers(), [4, 4], chunks=2, devices=[jax.devices()[0]],
               checkpoint="offload", **kwargs)
    with pytest.raises(ValueError) as te:
        GPipe(_torch_layers(), [4, 4], chunks=2, devices=["cpu"], checkpoint="offload",
              **kwargs)
    assert str(te.value) == str(je.value)


def _llama_step(checkpoint):
    params, _ = JGPipe(jt.llama(JCFG), [4]).init(
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((4, 16), jnp.int32))
    flat = [jax.tree_util.tree_map(np.asarray, p) for s in params for p in s]
    pipe = GPipe(params_from_jax(TCFG, flat, device="cpu"), [1, 2, 1], devices=["cpu"],
                 chunks=2, checkpoint=checkpoint)
    t = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 16)))
    loss, grads, _ = pipe.value_and_grad(
        t, t, lambda o, y: tt.cross_entropy(o[:, :-1], y[:, 1:]))
    return loss, [g for s in grads for d in s for g in d.values()], pipe


def test_offload_equals_never_bitwise():
    for run in (_llama_step, _conv_step):
        (lo, go, po), (ln, gn, _) = run("offload"), run("never")
        assert torch.equal(lo, ln), run.__name__
        assert all(torch.equal(a, b) for a, b in zip(go, gn)), run.__name__
        # A CPU stage keeps its tensors where they are.
        assert po.offload_stats["saved_bytes"] > 0
        assert po.offload_stats["moved_bytes"] == 0


def _conv_step(checkpoint):
    x, y = _data(0)
    pipe = GPipe(_torch_layers(), [4, 3, 1], chunks=3, devices=["cpu"],
                 checkpoint=checkpoint)
    loss, grads, _ = pipe.value_and_grad(nchw(x), torch.from_numpy(y).long(),
                                         torch_mean_loss)
    return loss, [g for s in grads for d in s for g in d.values()] + _state(pipe), pipe


@pytest.mark.parametrize("batch,chunks", [(6, 3), (7, 2)])
def test_offload_saved_bytes_match_the_formula(batch, chunks):
    width = 16
    gen = torch.Generator().manual_seed(0)
    layers = [tnn.dense(8, width, device="cpu", generator=gen), tnn.relu(),
              tnn.dense(width, width, device="cpu", generator=gen), tnn.relu(),
              tnn.dense(width, 4, device="cpu", generator=gen)]
    pipe = GPipe(layers, [3, 2], chunks=chunks, devices=["cpu"], checkpoint="offload")
    x = torch.randn(batch, 8, generator=gen)
    pipe.value_and_grad(x, None, lambda out, _: out.square().mean())
    relus = 2   # one per stage
    assert pipe.offload_stats == {"saved_bytes": relus * batch * width * 4,
                                  "moved_bytes": 0}


def test_offload_hooks_skip_inputs_and_parameters():
    """The hooks leave the cell's inputs and the stage's parameters on
    the device (their storage stays alive for the step anyway) and take
    each other saved view once."""
    off = tckpt.Offload()
    lin = torch.nn.Linear(4, 4)
    x = torch.randn(3, 2, 4, requires_grad=True)
    with off.cell("c", torch.device("cpu"), [x, *lin.parameters()]):
        h = torch.relu(lin(x))
        y = (h @ lin.weight).sum()
    # Saved: the relu output, once (its [6, 4] reshape for the matmul
    # shares its storage); neither x's view nor the weight.
    assert off.saved_bytes == 3 * 2 * 4 * 4
    y.backward()
    assert x.grad is not None and lin.weight.grad is not None
