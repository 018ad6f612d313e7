"""torchgpipe_tpu_torch.utils.serialization against the JAX reference.

A port model holding the reference's weights must give the reference's
state dict: the same keys (``partitions.<stage>.<layer>.params<path>``,
``...state<path>``) and bitwise the same arrays (a convolution's kernel
as HWIO, BatchNorm's statistics as state).  A file the port writes loads
into the reference model, and the file the reference writes from it
loads back into a fresh port model bitwise.  bf16 leaves round-trip
bitwise through their uint16 bit pattern and the ``__dtypes__`` tag, and
a reference file's bf16 leaves (numpy's two-byte void) load too.
"""

import importlib

import jax
import jax.numpy as jnp
import os

import numpy as np
import pytest
import torch

from torchgpipe_tpu import GPipe as JGPipe
from torchgpipe_tpu.models import transformer as jt
from torchgpipe_tpu.utils import serialization as jser
from torchgpipe_tpu_torch import GPipe
from torchgpipe_tpu_torch.convert import layers_from_jax, params_from_jax
from torchgpipe_tpu_torch.distributed import DistributedGPipe, LocalTransport
from torchgpipe_tpu_torch.models import transformer as tt
from torchgpipe_tpu_torch.models.resnet import build_resnet
from torchgpipe_tpu_torch.utils import serialization as ser

jresnet = importlib.import_module("torchgpipe_tpu.models.resnet")

KW = dict(vocab=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2)


def _flat(tree):
    return [jax.tree_util.tree_map(np.asarray, leaf) for stage in tree for leaf in stage]


def _same_dict(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8)), k


@pytest.fixture(scope="module")
def llama_pair():
    jpipe = JGPipe(jt.llama(jt.TransformerConfig(**KW)), balance=[2, 2])
    params, state = jpipe.init(jax.random.PRNGKey(0), jax.ShapeDtypeStruct((2, 8), jnp.int32))
    model = params_from_jax(tt.TransformerConfig(**KW), _flat(params), device="cpu")
    return jpipe, params, state, GPipe(list(model), [2, 2], devices=["cpu"])


@pytest.fixture(scope="module")
def resnet_pair():
    jlayers = jresnet.build_resnet([1, 1, 1, 1], 10, base_width=4)
    jpipe = JGPipe(jlayers, balance=[7, len(jlayers) - 7])
    params, state = jpipe.init(jax.random.PRNGKey(1),
                               jax.ShapeDtypeStruct((2, 32, 32, 3), jnp.float32))
    layers = list(build_resnet([1, 1, 1, 1], 10, base_width=4, device="cpu"))
    layers_from_jax(layers, _flat(params), _flat(state))
    return jpipe, params, state, GPipe(layers, [7, len(layers) - 7], devices=["cpu"])


@pytest.mark.parametrize("pair", ["llama_pair", "resnet_pair"])
def test_state_dict_equals_the_references(pair, request):
    jpipe, params, state, pipe = request.getfixturevalue(pair)
    _same_dict(ser.state_dict(pipe), jser.state_dict(jpipe, params, state))


@pytest.mark.parametrize("pair", ["llama_pair", "resnet_pair"])
def test_port_file_loads_into_the_reference_and_back(pair, request, tmp_path):
    jpipe, params, state, pipe = request.getfixturevalue(pair)
    ser.save(str(tmp_path / "port"), ser.state_dict(pipe))
    jparams, jstate = jser.load_state_dict(jpipe, params, state,
                                           jser.load(str(tmp_path / "port.npz")))
    jser.save(str(tmp_path / "ref"), jser.state_dict(jpipe, jparams, jstate))
    fresh = GPipe(_fresh_layers(pair),
                  pipe.balance, devices=["cpu"])
    ser.load_state_dict(fresh, ser.load(str(tmp_path / "ref.npz")))
    for a, b in zip(list(pipe.parameters()) + list(pipe.buffers()),
                    list(fresh.parameters()) + list(fresh.buffers())):
        assert torch.equal(a, b)


def _fresh_layers(pair):
    if pair == "llama_pair":
        return list(tt.llama(tt.TransformerConfig(**KW), device="cpu",
                             generator=torch.Generator().manual_seed(9)))
    return list(build_resnet([1, 1, 1, 1], 10, base_width=4, device="cpu",
                             generator=torch.Generator().manual_seed(9)))


def test_bf16_round_trips_bitwise_and_reads_a_reference_bf16_file(tmp_path):
    cfg = tt.TransformerConfig(**KW, dtype=torch.bfloat16)

    def model(seed):
        return GPipe(list(tt.llama(cfg, device="cpu",
                                   generator=torch.Generator().manual_seed(seed))),
                     [1, 3], devices=["cpu"])

    a, b = model(0), model(1)
    d = ser.state_dict(a)
    assert "__dtypes__" in d and d["partitions.0.embed.params['table']"].dtype == np.uint16
    ser.save(str(tmp_path / "bf16.npz"), d)
    ser.load_state_dict(b, ser.load(str(tmp_path / "bf16.npz")))
    assert all(torch.equal(x.view(torch.int16), y.view(torch.int16))
               for x, y in zip(a.parameters(), b.parameters()))
    # The reference writes bf16 as numpy's two-byte void: it loads too.
    jcfg = jt.TransformerConfig(**KW, dtype=jnp.bfloat16)
    jpipe = JGPipe(jt.llama(jcfg), balance=[1, 3])
    jp, js = jpipe.init(jax.random.PRNGKey(2), jax.ShapeDtypeStruct((2, 8), jnp.int32))
    jser.save(str(tmp_path / "ref.npz"), jser.state_dict(jpipe, jp, js))
    ser.load_state_dict(b, ser.load(str(tmp_path / "ref.npz")))
    want = np.asarray(jp[0][0]["table"]).view(np.uint16)
    got = b.partitions[0][0].table.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, want)


def test_a_distributed_rank_saves_its_own_stage(llama_pair, tmp_path):
    _, _, _, pipe = llama_pair
    transport = LocalTransport()
    rank = DistributedGPipe(list(pipe), 1, ["a", "b"], [2, 2], chunks=1,
                            transport=transport, mailbox=transport.register("b"),
                            device="cpu")
    d = ser.state_dict(rank)
    full = ser.state_dict(pipe)
    assert sorted(d) == sorted(k for k in full if k.startswith("partitions.1."))
    ser.save(str(tmp_path / "r1"), d)
    ser.load_state_dict(rank, ser.load(str(tmp_path / "r1.npz")))


def test_load_is_strict(llama_pair):
    _, _, _, pipe = llama_pair
    d = ser.state_dict(pipe)
    missing = dict(d)
    key = "partitions.0.embed.params['table']"
    del missing[key]
    with pytest.raises(KeyError, match="missing"):
        ser.load_state_dict(pipe, missing)
    with pytest.raises(KeyError, match="unexpected keys"):
        ser.load_state_dict(pipe, dict(d, extra=np.zeros(1)))
    with pytest.raises(ValueError, match="shape mismatch"):
        ser.load_state_dict(pipe, dict(d, **{key: np.zeros((2, 2), np.float32)}))


def test_save_appends_npz_and_sharded_checkpoints_wait(tmp_path):
    """``save`` appends ``.npz``; the sharded checkpoints (once refused,
    now ported) round-trip in one process: one rank's piece of a bf16
    leaf (its left half) and a whole leaf, read back as a slice of the
    piece bitwise; the rest of the leaf is in no file, so a whole read
    fails; a second save replaces the first through the temp directory."""
    ser.save(str(tmp_path / "x"), {"a": np.arange(3)})
    assert list(ser.load(str(tmp_path / "x.npz"))) == ["a"]
    assert not [p for p in tmp_path.iterdir() if ".tmp" in p.name]
    w = torch.randn(4, 6, generator=torch.Generator().manual_seed(0)).bfloat16()
    tree = {"w": ser.Shard(w[:, :3], (4, 6), (0, 0)), "n": np.arange(5, dtype=np.int32)}
    ser.save_sharded(str(tmp_path / "s"), tree)
    ser.save_sharded(str(tmp_path / "s"), tree)
    assert sorted(os.listdir(tmp_path / "s")) == ["rank_00000.npz"]
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("s.")]
    with pytest.raises(Exception, match="do not cover"):
        ser.restore_sharded(str(tmp_path / "s"), {"w": torch.empty(4, 6, dtype=torch.bfloat16),
                                                  "n": np.zeros(5, np.int32)})
    back = ser.restore_sharded(str(tmp_path / "s"), {
        "w": ser.Shard(torch.empty(2, 3, dtype=torch.bfloat16), (4, 6), (1, 0)),
        "n": np.zeros(5, np.int32)})
    assert torch.equal(back["w"], w[1:3, :3]) and back["w"].dtype == torch.bfloat16
    assert np.array_equal(back["n"], np.arange(5)) and back["n"].dtype == np.int32
    with pytest.raises(FileExistsError):
        ser.save_sharded(str(tmp_path / "s"), {"n": tree["n"]}, overwrite=False)
