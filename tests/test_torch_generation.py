"""torchgpipe_tpu_torch.models.generation against the JAX reference.

A tiny float32 Llama (dim 256, 2 heads, 1 kv head, head dim 128, 2
layers, vocab 512) is initialised by the reference, converted with
``params_from_jax`` and run through both packages on the CPU.

Tolerance for logits: each side computes the same float32 network, in
another summation order (matmuls over 256-512 terms, softmax over 128
keys).  Relative float32 error per op ~1e-7 * sqrt(terms) compounds over
2 blocks and the head to ~1e-6 relative on logits of magnitude ~3;
5e-5 absolute leaves more than an order of magnitude.  Greedy tokens
must be EQUAL: a 1e-6 logit perturbation flips an argmax only at a
near-tie, which this seeded case does not have (the test pins it).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.layers import sequential_init
from torchgpipe_tpu.models import generation as jg
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import generation as tg
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.models.moe import MoEConfig
from torchgpipe_tpu_torch.ops import flash_attention as tfa

LOGIT_TOL = 5e-5
KW = dict(vocab=512, dim=256, n_layers=2, n_heads=2, n_kv_heads=1)
JCFG, TCFG = jt.TransformerConfig(**KW), tt.TransformerConfig(**KW)


@pytest.fixture(scope="module")
def tiny():
    layers = jt.llama(JCFG)
    params, _, _ = sequential_init(
        layers, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 128), jnp.int32)
    )
    model = params_from_jax(
        TCFG, jax.tree_util.tree_map(np.asarray, params), device="cpu"
    )
    prompt = np.random.default_rng(0).integers(0, 512, (2, 128)).astype(np.int32)
    return params, model, prompt


def test_prefill_matches_jax_flash_prefill(tiny):
    params, model, prompt = tiny
    ref, jcache = jg.prefill(JCFG, params, jnp.asarray(prompt), 192,
                             use_flash=True)
    out, cache = tg.prefill(TCFG, model, prompt, 192, device="cpu")
    assert out.shape == (2, 512) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_TOL, rtol=0)
    assert cache.length == 128
    for a, b in zip(cache.k, jcache.k):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LOGIT_TOL, rtol=0)


def test_greedy_generate_equals_jax(tiny):
    params, model, prompt = tiny
    ref = np.asarray(jg.generate(JCFG, params, jnp.asarray(prompt), 128))
    fwd0, dec0 = tfa.flash_attention.launches, tfa.flash_decode_attention.launches
    out = tg.generate(TCFG, model, prompt, 128, device="cpu")
    assert out.shape == (2, 128)
    np.testing.assert_array_equal(out.numpy(), ref)
    # CPU tensors run the plain versions: no kernel launch is counted.
    assert tfa.flash_attention.launches == fwd0
    assert tfa.flash_decode_attention.launches == dec0


def test_eos_masking_matches_jax(tiny):
    """Rows freeze on eos and stop writing their cache, as in JAX."""
    params, model, prompt = tiny
    greedy = np.asarray(jg.generate(JCFG, params, jnp.asarray(prompt[:, :32]), 24))
    eos = int(greedy[0, 5])
    ref, jcache = jg.generate(JCFG, params, jnp.asarray(prompt[:, :32]), 24,
                              eos_id=eos, return_state=True)
    out, cache = tg.generate(TCFG, model, prompt[:, :32], 24, eos_id=eos,
                             return_state=True, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out.numpy()[0, 6:] == eos).all()
    for a, b in zip(cache.v, jcache.v):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize(
    "temperature,top_k,top_p",
    [(1.0, 5, None), (0.7, None, 0.9), (1.3, 50, 0.5), (1.0, None, 1.0)],
)
def test_filter_logits_matches_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(1).standard_normal((3, 512), np.float32) * 3
    ref = np.asarray(jg._filter_logits(jnp.asarray(logits), temperature, top_k, top_p))
    out = tg._filter_logits(torch.from_numpy(logits), temperature, top_k, top_p)
    np.testing.assert_array_equal(np.isinf(out.numpy()), np.isinf(ref))
    kept = ~np.isinf(ref)
    np.testing.assert_allclose(out.numpy()[kept], ref[kept], rtol=1e-6, atol=0)


def test_sampling_is_seeded_and_greedy_ties_pick_first():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0]])
    assert tg._sample(logits, None, 0.0, None).item() == 1
    big = torch.randn(4, 512, generator=torch.Generator().manual_seed(0))
    a = tg._sample(big, torch.Generator().manual_seed(7), 1.0, 20, 0.9)
    b = tg._sample(big, torch.Generator().manual_seed(7), 1.0, 20, 0.9)
    assert torch.equal(a, b)
    allowed = torch.topk(big, 20).indices
    assert all(a[i] in allowed[i] for i in range(4))


def test_sampled_generate_runs(tiny):
    _, model, prompt = tiny
    gen = torch.Generator().manual_seed(3)
    out = tg.generate(TCFG, model, prompt[:, :16], 8, temperature=0.8, top_k=40,
                      generator=gen, device="cpu")
    assert out.shape == (2, 8) and int(out.min()) >= 0 and int(out.max()) < 512
    with pytest.raises(ValueError, match="generator"):
        tg.generate(TCFG, model, prompt, 2, temperature=1.0, device="cpu")


EP = MoEConfig(ep_axis="ep")


@pytest.mark.parametrize(
    "kwargs",
    [{"entry": "generate", "moe": EP}, {"entry": "prefill", "moe": EP},
     {"entry": "beam_search", "moe": EP},
     {"entry": "speculative_generate", "draft_moe": EP}],
)
def test_unported_options_raise_with_roadmap_item(tiny, kwargs):
    """MoE feed-forwards are ported; a MoE config with an expert-parallel
    axis (ROADMAP queue A item 5.4, the SPMD engine) is what the
    generation entry points still refuse."""
    _, model, prompt = tiny
    kwargs = dict(kwargs)
    fn = getattr(tg, kwargs.pop("entry"))
    args = {"generate": (prompt, 2), "prefill": (prompt, 130),
            "beam_search": (prompt, 2),
            "speculative_generate": (TCFG, model, prompt, 2)}[fn.__name__]
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue A item 5"):
        fn(TCFG, model, *args, device="cpu", **kwargs)


def test_generate_without_device_or_card_raises(tiny, monkeypatch):
    _, model, prompt = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.generate(TCFG, model, prompt, 2)


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "import torchgpipe_tpu_torch, torchgpipe_tpu_torch.convert\n"
        "import torchgpipe_tpu_torch.models.transformer\n"
        "import torchgpipe_tpu_torch.models.generation\n"
        "import torchgpipe_tpu_torch.ops.flash_attention\n"
        "import torchgpipe_tpu_torch.ops._build\n"
        "import torchgpipe_tpu_torch.gpipe, torchgpipe_tpu_torch.pipeline\n"
        "import torchgpipe_tpu_torch.microbatch, torchgpipe_tpu_torch.partition\n"
        "import torchgpipe_tpu_torch.checkpoint\n"
        "import torchgpipe_tpu_torch.serving, torchgpipe_tpu_torch.obs\n"
        "import torchgpipe_tpu_torch.resilience, torchgpipe_tpu_torch.tune\n"
        "import torchgpipe_tpu_torch.skip, torchgpipe_tpu_torch.batchnorm\n"
        "import torchgpipe_tpu_torch.balance, torchgpipe_tpu_torch.balance.profile\n"
        "import torchgpipe_tpu_torch.ops.nn, torchgpipe_tpu_torch.models.resnet\n"
        "import torchgpipe_tpu_torch.precision, torchgpipe_tpu_torch.graphs\n"
        "import torchgpipe_tpu_torch.ops.losses\n"
        "import torchgpipe_tpu_torch.rng, torchgpipe_tpu_torch.models.lora\n"
        "import torchgpipe_tpu_torch.models.unet, torchgpipe_tpu_torch.models.vgg\n"
        "import torchgpipe_tpu_torch.utils.data, torchgpipe_tpu_torch.utils.tracing\n"
        "import torchgpipe_tpu_torch.models.vit, torchgpipe_tpu_torch.models.amoebanet\n"
        "import torchgpipe_tpu_torch.models.t5\n"
        "import torchgpipe_tpu_torch.models.moe, torchgpipe_tpu_torch.models.quant\n"
        "import torchgpipe_tpu_torch.auxgrad\n"
        "import torchgpipe_tpu_torch.distributed, torchgpipe_tpu_torch.distributed.context\n"
        "import torchgpipe_tpu_torch.distributed.gpipe, torchgpipe_tpu_torch.obs.flightrec\n"
        "import torchgpipe_tpu_torch.utils.serialization\n"
        "import torchgpipe_tpu_torch.resilience.faults, torchgpipe_tpu_torch.resilience.guard\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'torchgpipe_tpu' or m.startswith('torchgpipe_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
