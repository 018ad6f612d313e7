"""``GPipe(fused=True)``, the megastep and ``checkpoint='offload'`` on
the card; a small ViT's step and a GPT-2-class decode through the flash
kernels; float32 and head-dim-32 Llamas through the attention routes.

Needs an NVIDIA GPU; every test skips without one.  This file imports
neither JAX nor the JAX package (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda_training.py

A small bf16 Llama (vocab 256, dim 256, 2 blocks, 4 heads of 64, 2 kv
heads) at batch 4, seq 128, 2 micro-batches on 2 stages, random from a
seed, through the flash kernels.  A replayed graph runs the same
kernels on the same inputs, in the same order, as the eager step, so
losses, gradients, parameters and optimizer states must be bitwise
equal; any difference is a fault, not rounding.  Each comparison runs
an eager chain and a fused chain of steps from the same weights.
"""

import functools

import numpy as np
import pytest
import torch

from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.batchnorm import DeferredBatchNorm
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.ops import nn as tnn
from torchgpipe_tpu_torch.skip import Namespace, pop_add, stash

CFG = tt.TransformerConfig(vocab=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                           dtype=torch.bfloat16)
OPTS = {
    "sgd": functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9),
    "adamw": functools.partial(torch.optim.AdamW, lr=1e-3, capturable=True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (fused steps are CUDA graphs there)")
    return torch.device("cuda")


def _layers(seed=0):
    return list(tt.llama(CFG, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(seed)))


def _tokens(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, CFG.vocab, (4, 128))).cuda()


def _loss(out, target):
    tokens, scale = target if isinstance(target, tuple) else (target, None)
    loss = tt.cross_entropy(out[:, :-1], tokens[:, 1:])
    return loss if scale is None else loss * scale


def _state(pipe, optimizers=()):
    out = [t.detach().clone() for t in pipe.parameters()]
    out += [t.clone() for t in pipe.buffers()]
    out += [v.clone() for opt in optimizers for st in opt.state.values()
            for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def _load(pipe, state):
    with torch.no_grad():
        for t, s in zip(list(pipe.parameters()) + list(pipe.buffers()), state):
            t.copy_(s)


def _equal(a, b):
    return all(x.shape == y.shape and torch.equal(x.nan_to_num(), y.nan_to_num())
               and torch.equal(x.isnan(), y.isnan()) for x, y in zip(a, b)) \
        and len(a) == len(b)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", list(OPTS))
def test_fused_train_step_replays_equal_the_eager_step(cuda_device, opt):
    layers = _layers()
    fused = GPipe(layers, [2, 2], chunks=2, fused=True)
    eager = GPipe(layers, [2, 2], chunks=2)   # the same parameters
    w0 = _state(eager)
    inputs = [_tokens(1), _tokens(1), _tokens(2)]

    want = []
    estep = eager.make_train_step(OPTS[opt], _loss)
    for t in inputs:
        loss, _ = estep(t, t)
        want.append((loss.clone(), [p.grad.clone() for p in eager.parameters()],
                     _state(eager, estep.optimizers)))
    _load(fused, w0)
    fstep = fused.make_train_step(OPTS[opt], _loss)
    for i, t in enumerate(inputs):
        loss, _ = fstep(t, t)
        wl, wg, ws = want[i]
        assert torch.equal(loss, wl), (opt, i)
        assert _equal([p.grad for p in fused.parameters()], wg), (opt, i)
        assert _equal(_state(fused, fstep.optimizers), ws), (opt, i)
    # One capture (the first call is its warm-up); the new tokens of the
    # third call go through the static buffers.
    assert fused.graph_stats["captures"] == 1 and fused.graph_stats["replays"] == 2


@pytest.mark.cuda
def test_fused_value_and_grad_and_apply_replay(cuda_device):
    layers = _layers(1)
    fused = GPipe(layers, [2, 2], chunks=2, fused=True)
    eager = GPipe(layers, [2, 2], chunks=2)
    for t in (_tokens(3), _tokens(4), _tokens(3)):
        lf, gf, _ = fused.value_and_grad(t, t, _loss)
        gf = [g.clone() for s in gf for d in s for g in d.values()]
        lf = lf.clone()
        le, ge, _ = eager.value_and_grad(t, t, _loss)
        assert torch.equal(lf, le)
        assert _equal(gf, [g for s in ge for d in s for g in d.values()])
        assert torch.equal(fused.apply(t), eager.apply(t))
    assert fused.graph_stats["captures"] == 2   # value_and_grad and apply
    assert fused.graph_stats["replays"] == 4


@pytest.mark.cuda
def test_fused_megastep_skips_a_nan_step_as_single_steps_do(cuda_device):
    """Two megastep calls (K=3, AdamW capturable); the second, a replay,
    has a NaN loss scale at its inner step 1.  Against six single eager
    steps in which the test skips step 4 (snapshot and restore)."""
    k = 3
    layers = _layers(2)
    fused = GPipe(layers, [2, 2], chunks=2, fused=True, megastep=k)
    eager = GPipe(layers, [2, 2], chunks=2)
    w0 = _state(eager)
    toks = [_tokens(10 + i) for i in range(2 * k)]
    scales = [torch.tensor(1.0, device="cuda") for _ in range(2 * k)]
    scales[k + 1] = torch.tensor(float("nan"), device="cuda")

    estep = eager.make_train_step(OPTS["adamw"], _loss)
    want_losses = []
    for i in range(2 * k):
        before = _state(eager, estep.optimizers)
        loss, _ = estep(toks[i], (toks[i], scales[i]))
        want_losses.append(loss.clone())
        if i == k + 1:
            live = list(eager.parameters()) + list(eager.buffers()) + [
                v for o in estep.optimizers for st in o.state.values()
                for v in st.values() if isinstance(v, torch.Tensor)]
            with torch.no_grad():
                for t, s in zip(live, before):
                    t.copy_(s)
    want = _state(eager, estep.optimizers)

    _load(fused, w0)
    fstep = fused.make_train_step(OPTS["adamw"], _loss)
    got_losses, finite = [], []
    for c in range(2):
        xs = torch.stack(toks[c * k:(c + 1) * k])
        ss = torch.stack(scales[c * k:(c + 1) * k])
        losses, _, ok = fstep(xs, (xs, ss))
        got_losses += [x.clone() for x in losses]
        finite += ok.tolist()
    assert finite == [True] * (k + 1) + [False] + [True]
    assert _equal(got_losses, want_losses)
    assert _equal(_state(fused, fstep.optimizers), want)
    assert fused.graph_stats["captures"] == 1


@pytest.mark.cuda
def test_fused_refuses_a_host_step_count(cuda_device):
    pipe = GPipe(_layers(), [4], chunks=2, fused=True)
    with pytest.raises(ValueError, match="capturable=True"):
        pipe.make_train_step(functools.partial(torch.optim.AdamW, lr=1e-3), _loss)


@pytest.mark.cuda
def test_offload_moves_the_saved_tensors_and_equals_never(cuda_device):
    layers = _layers(3)
    t = _tokens(5)
    runs = {}
    for mode in ("never", "offload"):
        pipe = GPipe(layers, [2, 2], chunks=2, checkpoint=mode)
        loss, grads, _ = pipe.value_and_grad(t, t, _loss)
        runs[mode] = (loss.clone(), [g.clone() for s in grads for d in s for g in d.values()],
                      dict(pipe.offload_stats))
    (ln, gn, _), (lo, go, stats) = runs["never"], runs["offload"]
    assert torch.equal(ln, lo) and _equal(gn, go)
    assert stats["moved_bytes"] == stats["saved_bytes"] > 0


@pytest.mark.cuda
def test_fused_deferred_bn_conv_replays_equal_eager(cuda_device):
    """A float32 convolutional model with a skip and deferred batch norm
    (cuDNN in deterministic mode, so two eager steps agree bitwise)."""
    def layers():
        gen = torch.Generator("cuda").manual_seed(4)
        ns = Namespace()
        return [tnn.conv2d(3, 16, (3, 3), device="cuda", generator=gen),
                stash("res", ns=ns), tnn.batch_norm(16, device="cuda"), tnn.relu(),
                tnn.conv2d(16, 16, (3, 3), device="cuda", generator=gen),
                pop_add("res", ns=ns), tnn.global_avg_pool(),
                tnn.dense(16, 5, device="cuda", generator=gen)]

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        gen = torch.Generator("cuda").manual_seed(5)
        xs = [torch.randn(8, 3, 16, 16, device="cuda", generator=gen) for _ in range(3)]
        y = torch.randint(0, 5, (8,), device="cuda", generator=gen)
        loss_fn = lambda o, t: torch.nn.functional.cross_entropy(o, t)  # noqa: E731
        states = []
        for fused in (True, False):
            pipe = GPipe(layers(), [4, 4], chunks=2, deferred_batch_norm=True, fused=fused)
            for x in xs:
                pipe.value_and_grad(x, y, loss_fn)
            bn = next(m for m in pipe.modules() if isinstance(m, DeferredBatchNorm))
            assert int(bn.tracked) == 0 and bn._tracked == 0
            states.append(_state(pipe))
        assert _equal(*states)
    finally:
        torch.backends.cudnn.deterministic = det


@pytest.mark.cuda
def test_fused_step_takes_a_new_key_per_replay(cuda_device):
    """A dropout in a captured step: the key is a static input of the
    graph, so each replay draws the masks of its own key, bitwise as an
    eager step with that key does, and no key captures again."""
    gen = torch.Generator("cuda").manual_seed(3)
    layers = lambda: [tnn.dense(64, 64, device="cuda", generator=gen),  # noqa: E731
                      tnn.dropout(0.5), tnn.dense(64, 8, device="cuda", generator=gen)]
    eager_layers = layers()
    fused_layers = layers()
    with torch.no_grad():
        for a, b in zip(_params_of(fused_layers), _params_of(eager_layers)):
            a.copy_(b)
    eager = GPipe(eager_layers, [2, 1], chunks=2)
    fused = GPipe(fused_layers, [2, 1], chunks=2, fused=True)
    x = torch.randn(8, 64, device="cuda")

    def loss_fn(out, _):
        return out.square().mean()

    def run(pipe, rng):
        loss, _, _ = pipe.value_and_grad(x, None, loss_fn, rng=rng)
        return [loss.clone()] + [p.grad.clone() for p in pipe.parameters()]

    want = {k: run(eager, k) for k in (1, 2)}
    assert not _equal(want[1], want[2])
    for k in (1, 2, 1):      # the warm-up, then replays with other keys
        assert _equal(run(fused, k), want[k]), k
    assert fused.graph_stats["captures"] == 1 and fused.graph_stats["replays"] == 2


def _params_of(layers):
    return [p for layer in layers for p in layer.parameters()]


@pytest.mark.cuda
def test_lora_launch_counts(cuda_device):
    """LoRA fine-tuning of a headless Llama with the chunked loss runs
    every block's attention through the flash kernels, forward,
    recompute and backward (the adapters' gradients need dQ, dK and dV),
    leaves the frozen base weights without a gradient; a packed batch
    launches none of them; ``generate`` with unmerged adapters decodes
    through the decode kernel."""
    from torchgpipe_tpu_torch.models import generation as tg
    from torchgpipe_tpu_torch.models.lora import lora_optimizer
    from torchgpipe_tpu_torch.ops import flash_attention as tfa
    from torchgpipe_tpu_torch.utils.data import pack_documents, packed_batches

    cfg = tt.TransformerConfig(vocab=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                               dtype=torch.bfloat16, lora_rank=8)
    gen = torch.Generator("cuda").manual_seed(0)
    model = tt.llama(cfg, head=False, device="cuda", generator=gen)
    loss_layer = tt.chunked_lm_loss(cfg, chunk=64, device="cuda", generator=gen)
    pipe = GPipe(list(model), [3], chunks=2, checkpoint="except_last")
    opt = lora_optimizer(functools.partial(torch.optim.AdamW, lr=1e-3), pipe)(
        list(pipe.parameters()) + list(loss_layer.parameters()))
    tokens = _tokens(0)
    tfa.reset_launches()
    loss, _, _, _ = pipe.value_and_grad_with_loss_params(tokens[:, :-1], tokens[:, 1:],
                                                          loss_layer)
    opt.step()
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert (tfa.flash_attention.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == (n * 3, n * 2, n * 2)
    assert all(p.grad is None for name, p in pipe.named_parameters() if "lora" not in name)
    assert torch.isfinite(loss)
    rng = np.random.default_rng(1)
    docs = [rng.integers(1, cfg.vocab, int(k)) for k in rng.integers(8, 128, 12)]
    x, y = next(packed_batches(pack_documents(docs, 128), 4))
    x = {k: torch.from_numpy(v).long().cuda() for k, v in x.items()}
    y = {"labels": torch.from_numpy(y["labels"]).long().cuda(),
         "weights": torch.from_numpy(y["weights"]).cuda()}
    tfa.reset_launches()
    loss, _, _, _ = pipe.value_and_grad_with_loss_params(x, y, loss_layer)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert (tfa.flash_attention.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == (0, 0, 0)
    tfa.reset_launches()
    out = tg.generate(cfg, tg.mpmd_params_for_generation(pipe, head=loss_layer),
                      tokens[:2, :64], 8)
    assert out.shape == (2, 8)
    assert tfa.flash_attention.launches == n and tfa.flash_decode_attention.launches == n * 8


@pytest.mark.cuda
def test_vit_step_launches_and_replays_bitwise(cuda_device):
    """A small bf16 ViT (32x32 images, patch 8: 16 patches; dim 128, 2
    heads of 64, 2 blocks) trains through the flash kernels without a
    causal mask: 2 micro-batches under 'except_last' launch 2 x 2 + 1 x 2
    forwards and 2 x 2 of each backward kernel a step; ``fused=True``
    replays the eager steps bit for bit."""
    import torch.nn.functional as F

    from torchgpipe_tpu_torch.models.vit import vit
    from torchgpipe_tpu_torch.ops import flash_attention as tfa

    def build():
        return list(vit(image_size=32, patch_size=8, dim=128, depth=2, n_heads=2,
                        num_classes=10, dtype=torch.bfloat16, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0)))

    def loss_fn(out, tgt):
        return F.cross_entropy(out.float(), tgt)

    gen = torch.Generator("cuda").manual_seed(1)
    xs = [torch.randn(8, 3, 32, 32, device="cuda", generator=gen) for _ in range(3)]
    y = torch.randint(0, 10, (8,), device="cuda", generator=gen)
    eager = GPipe(build(), [2, 2], chunks=2, checkpoint="except_last")
    estep = eager.make_train_step(OPTS["sgd"], loss_fn)
    want = []
    for i, x in enumerate(xs):
        tfa.reset_launches()
        loss, _ = estep(x, y)
        torch.cuda.synchronize()
        if i == 0:
            assert (tfa.flash_attention.launches, tfa.flash_bwd_dq.launches,
                    tfa.flash_bwd_dkv.launches) == (6, 4, 4)
        want.append((loss.clone(), _state(eager, estep.optimizers)))
    fused = GPipe(build(), [2, 2], chunks=2, checkpoint="except_last", fused=True)
    fstep = fused.make_train_step(OPTS["sgd"], loss_fn)
    for i, x in enumerate(xs):
        loss, _ = fstep(x, y)
        assert torch.equal(loss, want[i][0]), i
        assert _equal(_state(fused, fstep.optimizers), want[i][1]), i
    assert fused.graph_stats["captures"] == 1 and fused.graph_stats["replays"] == 2


@pytest.mark.cuda
def test_gpt2_class_generate_decodes_through_flash_decode_at_mha(cuda_device):
    """A tied, learned-position GPT-2-class model (MHA: 4 heads of 64, one
    query row per kv head) decodes through ``flash_decode``: one prefill
    kernel a layer, one decode kernel a layer a token; its greedy tokens
    rank first in a teacher-forced forward (up to bf16 near-ties)."""
    from torchgpipe_tpu_torch.models import generation as tg
    from torchgpipe_tpu_torch.ops import flash_attention as tfa

    cfg = tt.TransformerConfig(vocab=256, dim=256, n_layers=2, n_heads=4, norm="layernorm",
                               pos_emb="learned", max_pos=128, mlp_impl="classic",
                               act="gelu_tanh", attn_bias=True, attn_out_bias=True,
                               tie_embeddings=True, dtype=torch.bfloat16)
    model = tt.llama_tied(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    prompt = _tokens(5)[:2, :64]
    tfa.reset_launches()
    out = tg.generate(cfg, model, prompt, 16)
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches, tfa.flash_decode_attention.launches) == (2, 2 * 16)
    with torch.inference_mode():
        logits = model(torch.cat([prompt, out[:, :-1]], 1))[:, 63:].float()
    gap = logits.max(-1).values - logits.gather(-1, out[..., None])[..., 0]
    # bf16 logits of ~1: the cached and the full path differ by a few bf16
    # roundings, so a token off the argmax must be a near-tie (2^-4).
    assert (logits.argmax(-1) == out).float().mean() >= 0.9 and bool((gap <= 2 ** -4).all())


# The routes on the card against the port on the CPU, from the same
# weights and tokens.  float32 (attention through csrc/flash_fwd_tf32.cu's
# 3xTF32 forward and csrc/flash_simt.cu's float32 backward, the decode
# kernel's float32 instantiation): one float32 network in another
# summation order (cuBLAS against the CPU's BLAS, the kernels' blocked
# softmax, 3xTF32's ~2^-21 per product),
# ~1e-6 relative per op: the loss to 1e-5 relative, each gradient leaf to
# 1e-4 of its max, greedy tokens equal (no near-tie at these seeds).
# bf16 at d=32 (the forward and backward kernels on a zero-padded head
# dim, flash_decode at d=32): the kernels round P and dS to bf16 where the
# plain version keeps float32, and each block rounds its products to
# bf16 (2^-8 relative), compounding over 2 blocks and the backward to a
# few 2^-8 of each leaf's scale: the loss to 2^-6 relative, gradients to
# 2^-4 of each leaf's max, tokens by the teacher-forced check.
ROUTE_CASES = {
    "float32": (dict(dtype=torch.float32), 1e-5, 1e-4),
    "bf16_d32": (dict(dtype=torch.bfloat16, n_head_dim=32), 2 ** -6, 2 ** -4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_routed_llama_trains_and_generates_as_on_the_cpu(cuda_device, case):
    from torchgpipe_tpu_torch.models import generation as tg
    from torchgpipe_tpu_torch.ops import flash_attention as tfa

    kw, loss_rtol, grad_rel = ROUTE_CASES[case]
    cfg = tt.TransformerConfig(vocab=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                               **kw)
    cpu = tt.llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = tt.llama(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tokens = _tokens(9)
    results = []
    tfa.reset_launches()
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        pipe = GPipe(list(model), [2, 2], devices=[dev], chunks=2)
        loss, _, _ = pipe.value_and_grad(tokens.to(dev), tokens.to(dev), _loss)
        results.append((float(loss), [p.grad.float().cpu() for p in pipe.parameters()]))
    train_f32, train_fwd = tfa.flash_attention_tf32.launches, tfa.flash_attention.launches
    assert tfa.flash_attention_f32.launches == 0
    (lc, gc), (lh, gh) = results
    assert lc == pytest.approx(lh, rel=loss_rtol)
    for a, b in zip(gc, gh):
        assert float((a - b).abs().max()) <= grad_rel * float(b.abs().max()), case
    if case == "float32":
        # the 3xTF32 backward (prologue, dQ, dK/dV) once per backward, and
        # none of flash_simt's.
        n_bwd = tfa.flash_bwd_dkv_tf32.launches
        assert train_f32 > 0 and train_fwd == 0 and n_bwd > 0
        assert (tfa.tf32_bwd_split.launches, tfa.flash_bwd_dq_tf32.launches) == (n_bwd, n_bwd)
        assert (tfa.flash_bwd_dq_f32.launches, tfa.flash_bwd_dkv_f32.launches) == (0, 0)
    else:
        assert train_f32 == 0 and train_fwd > 0 and tfa.flash_bwd_dq.launches > 0
    prompt = tokens[:2, :64]
    tfa.reset_launches()
    out = tg.generate(cfg, card, prompt, 12)
    torch.cuda.synchronize()
    if case == "float32":
        # prefill through the 3xTF32 forward a layer; decode through the
        # tensor-core decode (it takes a float32 cache at d=128).
        assert tfa.flash_attention_tf32.launches == 2
        assert tfa.flash_decode_attention.launches == 2 * 12
        want = tg.generate(cfg, cpu, prompt.cpu(), 12, device="cpu")
        assert torch.equal(out.cpu(), want)
    else:
        # prefill through the padded kernel; decode through flash_decode
        # at the real d=32 (a cache is never padded).
        assert tfa.flash_attention.launches == 2
        assert tfa.flash_decode_attention.launches == 2 * 12
        assert tfa.flash_decode_simt.launches == 0
        with torch.inference_mode():
            logits = card(torch.cat([prompt, out[:, :-1]], 1))[:, 63:].float()
        gap = logits.max(-1).values - logits.gather(-1, out[..., None])[..., 0]
        assert (logits.argmax(-1) == out).float().mean() >= 0.9 and bool((gap <= 2 ** -4).all())


@pytest.mark.cuda
def test_bf16_head_dim_128_counts_no_dense_route(cuda_device):
    """The tensor-core kernels' own case takes no other route: a training
    step and a generate of the bf16 d=128 Llama launch no padded or
    CUDA-core kernel."""
    from torchgpipe_tpu_torch.models import generation as tg
    from torchgpipe_tpu_torch.ops import flash_attention as tfa

    cfg = tt.TransformerConfig(vocab=256, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                               dtype=torch.bfloat16)
    model = tt.llama(cfg, device="cuda")
    tokens = _tokens(3)
    tfa.reset_launches()
    GPipe(list(model), [4], chunks=2).value_and_grad(tokens, tokens, _loss)
    tg.generate(cfg, model, tokens[:2, :32], 8)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_tf32.launches, tfa.flash_attention_f32.launches,
            tfa.flash_decode_simt.launches) == (0, 0, 0)
    assert (tfa.tf32_bwd_split.launches, tfa.flash_bwd_dq_tf32.launches,
            tfa.flash_bwd_dkv_tf32.launches) == (0, 0, 0)
    assert tfa.flash_attention.launches > 0 and tfa.flash_decode_attention.launches == 16


@pytest.mark.cuda
def test_mixtral_style_moe_step_is_deterministic_and_dropless_equals_sparse(cuda_device):
    """A bf16 dropless MoE Llama (``torch._grouped_mm`` on the card):
    two steps from the same weights give equal bits, and a 'sparse' run
    at capacity factor E/k (no drops) gives the same loss up to bf16
    rounding of its other product order (2^-6 relative)."""
    from torchgpipe_tpu_torch.models import moe as tm

    moe = tm.MoEConfig(n_experts=4, top_k=2, dispatch="dropless", balance_weight=0.02)
    model = tm.llama_moe(CFG, moe, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    tokens = _tokens(4)
    pipe = GPipe(list(model), [2, 2], chunks=2)
    runs = []
    for _ in range(2):
        loss, _, _ = pipe.value_and_grad(tokens, tokens, _loss)
        runs.append((loss.clone(), [p.grad.clone() for p in pipe.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    for block in list(model)[1:-1]:
        block.mlp.moe = tm.MoEConfig(n_experts=4, top_k=2, dispatch="sparse",
                                     capacity_factor=2.0, balance_weight=0.02)
    sparse, _, _ = pipe.value_and_grad(tokens, tokens, _loss)
    assert float(sparse) == pytest.approx(float(runs[0][0]), rel=2 ** -6)


@pytest.mark.cuda
def test_float32_dropless_moe_on_the_card_equals_the_cpu(cuda_device):
    """The dropless products of a float32 MoE layer on the card (every
    expert over every row, its own segment kept: no host read) equal the
    CPU's segment loop up to float32 summation order (1e-5 of max |y|,
    products over 256 and 768 terms)."""
    from torchgpipe_tpu_torch.models import moe as tm

    cfg = tt.TransformerConfig(vocab=256, dim=256, n_layers=1, n_heads=4)
    moe = tm.MoEConfig(n_experts=4, top_k=2, dispatch="dropless")
    cpu = tm.moe_mlp(cfg, moe, device="cpu", generator=torch.Generator().manual_seed(0))
    card = tm.MoEMLP(cfg, moe, device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 64, 256, generator=torch.Generator().manual_seed(1))
    want = cpu(x).detach()
    got = card(x.cuda()).detach().cpu()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
