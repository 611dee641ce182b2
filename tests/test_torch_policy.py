"""The port's policy engine (``repro_torch.core.policy``) and int8
error-feedback compression (``repro_torch.optim.compress``) against the
reference's (``repro.core.policy``, ``repro.optim.compress``).

Specs: every leaf of every assigned arch, at ``reduced()`` widths and at
full size (shapes only: the port's model on the ``meta`` device; the
reference's pytree through ``jax.eval_shape`` at the reduced size, where
its paths and stacked shapes are held to the port's), on three meshes and
under ZeRO 0, 1 and 3, parameters and optimizer state.  The port's layers
are unstacked: its spec of a layer's parameter must equal the reference's
spec of the stacked leaf with the stack entry dropped.  Compression: the
same numpy inputs through both sides; int8 payloads and residuals equal,
scales within one ulp.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import PolicyConfig as RefPolicy
from repro.core import policy as ref_policy
from repro.models import lm as ref_lm
from repro.optim import compress as ref_compress

from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.configs.base import PolicyConfig
from repro_torch.convert import reference_paths
from repro_torch.core import policy
from repro_torch.models.lm import LM
from repro_torch.optim import compress

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4})
ZERO = (0, 1, 3)


def _ref_leaves(tree):
    """path string -> leaf of a reference pytree (``_path_str``'s keys)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        out[ref_policy._path_str(path)] = leaf
    return out


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_leaf_spec_equals_the_reference(arch, size):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    if size == "reduced":
        cfg, ref_cfg = reduced(cfg), ref_reduced(ref_cfg)
    model = LM(cfg, device="meta")
    paths = reference_paths(model)
    if size == "reduced":
        shapes = jax.eval_shape(lambda k: ref_lm.init_lm(k, ref_cfg),
                                jax.random.PRNGKey(0))
        ref_shapes = _ref_leaves(shapes)
        # every reference leaf has its port parameters, at its stacked shape
        assert {p for p, _ in paths.values()} == set(ref_shapes)
        for name, (path, shape) in paths.items():
            assert shape == tuple(ref_shapes[path].shape), name
    else:
        # at full size (tracing init_lm's 40-64 layers costs a second an
        # arch) the reference's rules read the pytree of these paths
        shapes = {}
        for path, shape in paths.values():
            *parents, leaf = path.split("/")
            node = shapes
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = jax.ShapeDtypeStruct(shape, jnp.float32)
    n_sharded = 0
    for axes, zero in itertools.product(MESHES, ZERO):
        pol = PolicyConfig(zero_stage=zero)
        ref_pol = RefPolicy(zero_stage=zero)
        for ours_fn, ref_fn in ((policy.param_specs, ref_policy.param_specs),
                                (policy.opt_state_specs,
                                 ref_policy.opt_state_specs)):
            ours = ours_fn(model, cfg, pol, axes)
            ref = _ref_leaves(ref_fn(shapes, ref_cfg, ref_pol, axes))
            for name, (path, _) in paths.items():
                want = tuple(ref[path])
                skip = ref_policy._stack_skip(path, ref_cfg)
                want = want[skip:] if want else want
                assert ours[name] == want, (name, path, axes, zero)
                n_sharded += any(e is not None for e in ours[name])
    assert n_sharded > 0


def test_stacked_norm_is_sharded_as_in_the_reference():
    """llama3.2-3b's norm scale: 3072 elements alone, 86016 stacked over 28
    layers, so the reference shards it under ZeRO-3; so does the port."""
    cfg = get_config("llama3.2-3b")
    model = LM(cfg, device="meta")
    specs = policy.param_specs(model, cfg, PolicyConfig(zero_stage=3),
                               {"data": 4})
    assert specs["stack.blocks.0.norm1.scale"] == ("data",)
    assert specs["final_norm.scale"] == ()
    assert specs["embed"] == ("data", None)
    assert policy.local_shape((3072,), ("data",), {"data": 4}) == (768,)


def test_a_one_rank_mesh_shards_over_its_size_one_axis():
    """At ``data`` = 1 the reference's rule (``fsdp_min=2``) replicates
    every leaf.  The layout takes ``fsdp_min=1`` there: ZeRO-3 names the
    axis on every leaf the rule shards at all, each piece the whole
    tensor; on a wider mesh it is the reference's rule.  The checkpoint's
    specs (``trainer.state_specs``) are the layout's."""
    from repro_torch.train import sharding, trainer
    cfg = reduced(get_config("qwen2-0.5b"))
    model = LM(cfg, device="meta")
    zero3 = PolicyConfig(zero_stage=3, dp_axes=("data",))
    one = {"data": 1}
    assert not any(sharding.spec_axes(s) for s in policy.param_specs(
        model, cfg, zero3, one).values())
    ps, ms = sharding.specs(model, cfg, zero3, one)
    assert ps == ms
    stacked = {n: shape for n, (_, shape) in reference_paths(model).items()}
    for n, p in model.named_parameters():
        big = int(np.prod(stacked[n])) >= policy._REPLICATE_BELOW
        assert sharding.spec_axes(ps[n]) == (("data",) if big else ()), n
        assert policy.local_shape(p.shape, ps[n], one) == tuple(p.shape)
    assert sharding.specs(model, cfg, zero3, {"data": 4}) == (
        policy.param_specs(model, cfg, zero3, {"data": 4}),
        policy.opt_state_specs(model, cfg, zero3, {"data": 4}))

    class OneRank:
        mesh_dim_names = ("data",)
        mesh = torch.zeros(1)

    state = trainer.init_state(cfg, zero3, seed=0, device="cpu")
    assert trainer.state_specs(state, cfg, zero3, one) == \
        sharding.Layout(cfg, zero3, OneRank).leaf_specs(state)


@pytest.mark.parametrize("batch", [1, 2, 3, 4, 6, 8, 16, 32, 64])
def test_batch_specs_over_a_grid(batch):
    for axes in MESHES + ({"pod": 2, "data": 2}, {"pod": 4, "data": 1}):
        for dp in (("data",), ("pod", "data")):
            pol, ref_pol = (PolicyConfig(dp_axes=dp), RefPolicy(dp_axes=dp))
            assert policy.dp_spec_for_batch(batch, pol, axes) == \
                ref_policy.dp_spec_for_batch(batch, ref_pol, axes)
            ex = {"inputs": np.zeros((batch, 8), np.int32),
                  "labels": np.zeros((batch, 8), np.int32),
                  "step": np.zeros((), np.int32)}
            ours = policy.batch_specs(ex, pol, axes, seq_axis="model")
            ref = ref_policy.batch_specs(ex, ref_pol, axes, seq_axis="model")
            assert {k: tuple(v) for k, v in ref.items()} == ours


def test_ladder_equals_the_reference_field_by_field():
    base = PolicyConfig(grad_accum=2, remat="none")
    ref_base = RefPolicy(grad_accum=2, remat="none")
    ours, ref = policy.ladder(base), ref_policy.ladder(ref_base)
    assert list(ours) == list(ref) == ["DP", "DDP", "DDP+mixed",
                                       "DDP+mixed+sharded"]
    for rung in ours:
        a, b = dataclasses.asdict(ours[rung]), dataclasses.asdict(ref[rung])
        # the attention implementation's names differ by design
        assert a.pop("attn_impl") == "kernel" and b.pop("attn_impl") == "xla"
        assert a == b, rung


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data")

    assert policy.placements((), Mesh) == [Replicate(), Replicate()]
    assert policy.placements((None, "data"), Mesh) == [Replicate(), Shard(1)]
    assert policy.placements((("pod", "data"), None), Mesh) == \
        [Shard(0), Shard(0)]
    axes = {"pod": 2, "data": 4}
    assert policy.local_shape((16, 8), (("pod", "data"), None), axes) == \
        (2, 8)
    assert policy.local_shape((16, 8), (), axes) == (16, 8)
    with pytest.raises(ValueError, match="divide"):
        policy.local_shape((6, 8), ("data", None), axes)


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------
def _inputs(seed, shape=(37, 53)):
    rng = np.random.RandomState(seed)
    g = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 1)).astype(
        np.float32)
    r = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    return g, r


def _ulps(a, b):
    return abs(int(np.float32(a).view(np.int32))
               - int(np.float32(b).view(np.int32)))


@pytest.mark.parametrize("seed", range(4))
def test_compress_matches_the_reference(seed):
    g, r = _inputs(seed)
    # a value on a rounding boundary: half to even on both sides
    g.flat[0] = 0.0
    q, scale, new_r = compress.ef_compress_leaf(torch.from_numpy(g),
                                                torch.from_numpy(r))
    rq, rscale, rnew = ref_compress.ef_compress_leaf(jnp.asarray(g),
                                                     jnp.asarray(r))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert _ulps(float(scale), float(rscale)) <= 1
    np.testing.assert_array_equal(new_r.numpy(), np.asarray(rnew))
    np.testing.assert_array_equal(
        compress.int8_decode(q, scale).numpy(),
        np.asarray(ref_compress.int8_decode(rq, rscale)))


def test_int8_encode_global_max_rounding_and_floor():
    x = torch.tensor([0.5, 1.5, 2.5, -2.5, 127.0], dtype=torch.float32)
    q, scale = compress.int8_encode(x, lambda m: torch.full_like(m, 127.0))
    rq, rscale = ref_compress.int8_encode(jnp.asarray(x.numpy()),
                                          lambda m: jnp.float32(127.0))
    assert float(scale) == float(rscale) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.tolist() == [0, 2, 2, -2, 127]          # half to even
    z, zs = compress.int8_encode(torch.zeros(3))
    assert float(zs) == np.float32(np.float32(1e-30) / np.float32(127.0))
    assert z.tolist() == [0, 0, 0]
    assert compress.compression_ratio() == ref_compress.compression_ratio()
    assert compress.compression_ratio(torch.bfloat16) == \
        ref_compress.compression_ratio(jnp.bfloat16) == 2.0
