"""torchgpipe_tpu_torch.models.transformer against the JAX reference.

Same numpy inputs through both packages, float32 on the CPU.  Rotary
and norms are elementwise float32 formulas: they differ by a few ulps
(cos/sin and rsqrt implementations), so 1e-5 on O(1) values.  A block
forward adds float32 matmuls over dim=256 and a softmax over 64 keys in
another summation order: a few ulps times sqrt(256) terms, well under
1e-4 on O(1) activations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu_torch.convert import params_from_jax
from torchgpipe_tpu_torch.models import transformer as tt

ELEM_TOL = 1e-5
BLOCK_TOL = 1e-4


@pytest.mark.parametrize("offset", [0, 37, np.array([0, 5, 900], np.int32)])
@pytest.mark.parametrize("pct", [1.0, 0.5])
def test_rope_matches_jax(offset, pct):
    x = np.random.default_rng(0).standard_normal((3, 7, 2, 64), np.float32)
    jcfg = jt.TransformerConfig(dim=128, n_heads=2, rope_pct=pct)
    tcfg = tt.TransformerConfig(dim=128, n_heads=2, rope_pct=pct)
    ref = jt._maybe_rope(jcfg, jnp.asarray(x), jnp.asarray(offset))
    off = torch.from_numpy(offset) if isinstance(offset, np.ndarray) else offset
    out = tt._maybe_rope(tcfg, torch.from_numpy(x), off)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ELEM_TOL, rtol=0)


@pytest.mark.parametrize("centered", [False, True])
def test_norm_matches_jax(centered):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 96), np.float32) * 3
    scale = rng.standard_normal(96).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32) if centered else None
    ref = jt._norm(jnp.asarray(x), jnp.asarray(scale), 1e-5,
                   bias=None if bias is None else jnp.asarray(bias),
                   centered=centered)
    out = tt._norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5,
                   bias=None if bias is None else torch.from_numpy(bias),
                   centered=centered)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ELEM_TOL, rtol=0)


def test_norm_bf16_cast_order_matches_jax():
    """bfloat16 input: variance in f32, the scale product in bf16.  Same
    roundings in the same order give the same bits up to one bf16 ulp
    where XLA fuses the two products (2^-7 relative)."""
    x = np.random.default_rng(2).standard_normal((4, 64), np.float32)
    ref = np.asarray(jt._rms(jnp.asarray(x, jnp.bfloat16), jnp.ones(64), 1e-5),
                     np.float32)
    out = tt._rms(torch.from_numpy(x).bfloat16(), torch.ones(64), 1e-5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize(
    "knobs",
    [
        {},
        {"attn_window": 16, "n_kv_heads": 1},
        {"attn_bias": True, "qk_norm": True, "attn_out_bias": True,
         "parallel_residual": True, "rope_pct": 0.5},
        {"norm": "layernorm", "mlp_impl": "classic", "act": "gelu"},
    ],
)
def test_block_forward_matches_jax(knobs):
    kw = {"vocab": 64, "dim": 256, "n_layers": 1, "n_heads": 4,
          "n_kv_heads": 2, **knobs}
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    x = np.random.default_rng(3).standard_normal((2, 64, 256), np.float32)
    layer = jt.transformer_block(jcfg)
    params, _ = layer.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # Non-trivial biases / norm scales so every knob's term is visible.
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(2), a.shape)
        if a.ndim == 1 else a, params,
    )
    ref, _ = layer.apply(params, (), jnp.asarray(x), rng=None, train=False)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    embed = {"table": np.zeros((64, 256), np.float32)}
    head = {"scale": np.ones(256, np.float32), "w": np.zeros((256, 64), np.float32)}
    if tcfg.norm == "layernorm":
        head["bias"] = np.zeros(256, np.float32)
    model = params_from_jax(tcfg, [embed, np_params, head], device="cpu")
    out = model[1](torch.from_numpy(x)).detach()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=BLOCK_TOL, rtol=0)


def test_config_shapes_match_reference():
    """Llama-3-8B width: the derived sizes the slice runs at."""
    kw = dict(vocab=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
              mlp_ratio=5.25)
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    assert (tcfg.kv_heads, tcfg.head_dim, tcfg.mlp_hidden) == (8, 128, 14336)
    assert (tcfg.kv_heads, tcfg.head_dim, tcfg.mlp_hidden) == (
        jcfg.kv_heads, jcfg.head_dim, jcfg.mlp_hidden
    )


def test_init_distributions_follow_reference():
    """Same distributions as the JAX init (different streams)."""
    cfg = tt.TransformerConfig(vocab=512, dim=256, n_layers=1, n_heads=2)
    gen = torch.Generator().manual_seed(0)
    m = tt.llama(cfg, device="cpu", generator=gen)
    blk = m[1]
    assert blk.ln1.dtype == torch.float32 and torch.all(blk.ln1 == 1)
    assert abs(blk.wq.std().item() - 256 ** -0.5) < 0.01
    assert abs(blk.w_down.std().item() - cfg.mlp_hidden ** -0.5) < 0.01
    assert abs(m[0].table.std().item() - 0.02) < 0.002
    assert abs(m[-1].w.std().item() - 256 ** -0.5) < 0.01
    assert sorted(blk.params()) == sorted(
        ["ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down"]
    )


@pytest.mark.parametrize(
    # lora_rank is ported (tests/test_torch_lora.py), and so are tied
    # embeddings and learned positions (tests/test_torch_arch_knobs.py),
    # and the parallel axes (tests/test_torch_tensor_parallel.py,
    # test_torch_ring_attention.py, test_torch_ulysses.py).
    "knob", [{"tp_axis": "tp"}, {"sp_axis": "sp"},
             {"tp_axis": "tp", "sp_axis": "sp"},
             {"sp_axis": "sp", "sp_impl": "ulysses"}]
)
def test_unported_knobs_raise_with_roadmap_item(knob):
    """The parallel axes build, and outside an engine that binds them the
    model computes the unsharded math; so does a MoE expert-parallel axis
    (ROADMAP A.5.4e2, which used to raise): the layer declares it, and
    unbound every expert is local."""
    from torchgpipe_tpu_torch.models.moe import MoEConfig, moe_mlp

    cfg = tt.TransformerConfig(vocab=64, dim=64, n_layers=1, n_heads=2,
                               dtype=torch.float32, **knob)
    plain = tt.TransformerConfig(vocab=64, dim=64, n_layers=1, n_heads=2,
                                 dtype=torch.float32)
    tokens = torch.arange(12).reshape(2, 6) % 64
    torch.testing.assert_close(tt.llama(cfg, device="cpu")(tokens),
                               tt.llama(plain, device="cpu")(tokens), rtol=0, atol=0)
    axis = knob.get("tp_axis") or knob["sp_axis"]
    ep, local = (moe_mlp(plain, MoEConfig(ep_axis=a), device="cpu",
                         generator=torch.Generator().manual_seed(0)) for a in (axis, None))
    x = torch.randn(2, 6, 64, generator=torch.Generator().manual_seed(1))
    assert ep.meta["ep_axis"] == axis and local.meta["ep_axis"] is None
    torch.testing.assert_close(ep(x), local(x), rtol=0, atol=0)


def test_no_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tt.TransformerConfig(vocab=64, dim=64, n_layers=1, n_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.llama(cfg)
