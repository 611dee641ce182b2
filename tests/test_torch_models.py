"""Port vs reference: attention paths, the block stack and the LM forward.

Weights are made with numpy from a seed (the reference's own init gives the
tree and each leaf's mean and spread), handed to the reference as they are
and to the port through ``repro_torch.convert.from_reference``.  Everything
runs on the CPU in fp32 with ``attn_impl="full"`` on the reference side.

Tolerance ``atol = rtol = 2e-4`` for logits: fp32 throughout, but matmuls and
softmax sum in another order on the two sides and the differences compound
over two layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import PolicyConfig as RefPolicy
from repro.models import attention as ref_attention
from repro.models import lm as ref_lm
from repro.models import transformer as ref_transformer
from repro.train.trainer import make_run_ctx as ref_make_run_ctx

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig
from repro_torch.kernels import ops
from repro_torch.models import attention, moe, transformer
from repro_torch.models.lm import LM
from repro_torch.train import trainer
from repro_torch.train.trainer import make_run_ctx

TOL = dict(atol=2e-4, rtol=2e-4)
DENSE_ARCHS = ["qwen2-0.5b", "llama3.2-3b", "stablelm-12b", "command-r-35b"]
REF_POLICY = RefPolicy(compute_dtype="float32", remat="none",
                       attn_impl="full")


def numpy_params(ref_cfg, seed=0):
    """The reference's parameter tree with every leaf redrawn by numpy:
    ``mean(leaf) + randn * (std(leaf) or 0.1)`` -- weights keep their init
    spread, norm scales move off 1 and biases off 0."""
    tree = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    r = np.random.RandomState(seed)

    def redraw(a):
        a = np.asarray(a)
        std = float(a.std()) or 0.1
        return (float(a.mean())
                + r.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree.map(redraw, tree)


def both(arch, kernel=False, seed=0, **cfg_kw):
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), **cfg_kw)
    cfg = dataclasses.replace(reduced(get_config(arch)), **cfg_kw)
    params = numpy_params(ref_cfg, seed)
    model = convert.from_reference(params, cfg, dtype=torch.float32,
                                   device="cpu").eval()
    policy = PolicyConfig(compute_dtype="float32", remat="none",
                          attn_impl="kernel" if kernel else "full")
    return (ref_cfg, jax.tree.map(jnp.asarray, params),
            ref_make_run_ctx(ref_cfg, REF_POLICY, None),
            cfg, model, make_run_ctx(cfg, policy))


def _tokens(cfg, B, S, seed=1):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# attention functions
# ---------------------------------------------------------------------------
def _qkv(B, S, T, H, K, D, seed=0):
    r = np.random.RandomState(seed)
    return (r.standard_normal((B, S, H, D)).astype(np.float32),
            r.standard_normal((B, T, K, D)).astype(np.float32),
            r.standard_normal((B, T, K, D)).astype(np.float32))


@pytest.mark.parametrize("causal,softcap,masked", [
    (True, 0.0, False), (False, 0.0, True), (True, 30.0, True)])
def test_full_attention_matches_reference(causal, softcap, masked):
    q, k, v = _qkv(2, 12, 12, 6, 2, 16)
    mask = None
    if masked:
        mask = np.arange(12)[None, :] < np.asarray([[9], [12]])
    want = ref_attention.full_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        softcap=softcap, kv_mask=None if mask is None else jnp.asarray(mask))
    got = attention.full_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, softcap=softcap,
        kv_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_decode_and_chunk_attention_match_reference():
    q, k, v = _qkv(2, 5, 24, 4, 2, 16, seed=2)
    cache_pos = np.where(np.arange(24)[None] < np.asarray([[20], [11]]),
                         np.arange(24)[None], -1).astype(np.int32)
    q_pos = np.stack([np.arange(15, 20), np.arange(6, 11)]).astype(np.int32)
    want = ref_attention.chunk_decode_attention(
        *(jnp.asarray(a) for a in (q, k, v, cache_pos, q_pos)), softcap=20.0)
    got = attention.chunk_decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, cache_pos, q_pos)),
        softcap=20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    want = ref_attention.decode_attention(
        *(jnp.asarray(a) for a in (q[:, :1], k, v, cache_pos)))
    got = attention.decode_attention(
        *(torch.from_numpy(a) for a in (q[:, :1], k, v, cache_pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_build_cache_from_prefill_matches_reference():
    _, k, v = _qkv(2, 1, 6, 2, 2, 8, seed=3)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    mask = np.arange(6)[None, :] < np.asarray([[4], [6]])
    want = ref_attention.build_cache_from_prefill(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), window=0,
        capacity=10, kv_mask=jnp.asarray(mask))
    got = attention.build_cache_from_prefill(
        torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos.copy()), window=0, capacity=10,
        kv_mask=torch.from_numpy(mask))
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert got["pos"][0, 4] == -1 and got["pos"].dtype == torch.int32


def test_plan_segments_matches_reference():
    for pat in [("attn",) * 5, ("rglru", "rglru", "attn_local") * 3,
                ("ssm", "attn") * 2 + ("ssm",), ("attn",)]:
        assert transformer.plan_segments(pat) == \
            ref_transformer.plan_segments(pat)


# ---------------------------------------------------------------------------
# LM forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("kernel", [False, True], ids=["full", "kernel"])
def test_lm_forward_matches_reference(arch, kernel):
    ref_cfg, ref_params, ref_ctx, cfg, model, ctx = both(arch, kernel)
    toks = _tokens(cfg, 2, 24)
    want, _, _ = ref_lm.forward(ref_params, jnp.asarray(toks), ref_cfg,
                                ref_ctx)
    with torch.no_grad():
        got, caches, aux = model(torch.from_numpy(toks), ctx)
    assert caches is None and float(aux) == 0.0
    assert got.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lm_forward_untied_bias_qknorm_layernorm_variants():
    """Variants the four archs do not cover together: untied head, qkv bias,
    qk-norm, layernorm with bias, gelu, a 3-layer stack (unstacking)."""
    ref_cfg, ref_params, ref_ctx, cfg, model, ctx = both(
        "qwen2-0.5b", tie_embeddings=False, qkv_bias=True, qk_norm=True,
        norm="layernorm", act="gelu", n_layers=3,
        block_pattern=("attn",) * 3, rope_fraction=0.5, logit_softcap=20.0)
    toks = _tokens(cfg, 1, 17)
    want, _, _ = ref_lm.forward(ref_params, jnp.asarray(toks), ref_cfg,
                                ref_ctx)
    with torch.no_grad():
        got, _, _ = model(torch.from_numpy(toks), ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_then_decode_equals_full_forward():
    """Prefill (building caches), then one token at a time, reproduces the
    full forward's logits -- on the port alone and against the reference."""
    ref_cfg, ref_params, ref_ctx, cfg, model, ctx = both("llama3.2-3b",
                                                         kernel=True)
    toks = _tokens(cfg, 2, 20)
    ctx = dataclasses.replace(ctx, cache_capacity=32)
    ref_ctx = dataclasses.replace(ref_ctx, cache_capacity=32)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        full, _, _ = model(t, ctx)
        logits, caches, _ = model(t[:, :14], ctx, caches="init")
        np.testing.assert_allclose(logits.numpy(), full[:, :14].numpy(),
                                   **TOL)
        for i in range(14, 20):
            pos = torch.full((2, 1), i, dtype=torch.int32)
            logits, caches, _ = model(t[:, i:i + 1], ctx, positions=pos,
                                      caches=caches)
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       full[:, i].numpy(), **TOL)
    want, _, _ = ref_lm.forward(ref_params, jnp.asarray(toks), ref_cfg,
                                ref_ctx)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), **TOL)
    assert caches[0]["k"].shape == (2, 32, cfg.n_kv_heads, cfg.head_dim)


def test_chunked_prefill_matches_one_shot_and_reference():
    ref_cfg, ref_params, ref_ctx, cfg, model, ctx = both("qwen2-0.5b")
    ctx = dataclasses.replace(ctx, cache_capacity=32)
    ref_ctx = dataclasses.replace(ref_ctx, cache_capacity=32)
    toks = _tokens(cfg, 1, 21, seed=3)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        h1, c1, _ = model(t, ctx, caches="init", return_hidden=True)
        h, caches = None, "init"
        for s, e in ((0, 8), (8, 16), (16, 21)):      # uneven chunks
            pos = torch.arange(s, e, dtype=torch.int32)[None, :]
            h, caches, _ = model(t[:, s:e], ctx, positions=pos,
                                 caches=caches, return_hidden=True)
    np.testing.assert_allclose(h1[:, -1].numpy(), h[:, -1].numpy(),
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(c1, caches):
        for name in ("k", "v", "pos"):
            np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                       atol=1e-5, rtol=1e-5)
    want, ref_caches, _ = ref_lm.forward(
        ref_params, jnp.asarray(toks), ref_cfg, ref_ctx, caches="init",
        return_hidden=True)
    np.testing.assert_allclose(h1.numpy(), np.asarray(want), **TOL)
    # the reference stacks its two layers' caches along a leading axis
    ref_k = np.asarray(ref_caches["seg0"]["slot0"]["k"])
    for i, c in enumerate(c1):
        np.testing.assert_allclose(c["k"].numpy(), ref_k[i], **TOL)


def test_bucketed_prefill_mask_marks_padding_empty():
    _, _, _, cfg, model, ctx = both("qwen2-0.5b", kernel=True)
    ctx = dataclasses.replace(ctx, cache_capacity=32)
    toks = torch.from_numpy(_tokens(cfg, 1, 16))
    pos = torch.arange(16, dtype=torch.int32)[None]
    mask = pos < 11
    with torch.no_grad():
        padded, caches, _ = model(toks, ctx, positions=pos, caches="init",
                                  kv_mask=mask)
        exact, _, _ = model(toks[:, :11], ctx)
    np.testing.assert_allclose(padded[:, :11].numpy(), exact.numpy(), **TOL)
    assert (caches[0]["pos"][0, :11] >= 0).all()
    assert (caches[0]["pos"][0, 11:] == -1).all()


# ---------------------------------------------------------------------------
# conversion, casting, what is not ported
# ---------------------------------------------------------------------------
def test_to_reference_round_trips():
    ref_cfg = ref_reduced(ref_get_config("stablelm-12b"), n_layers=3)
    cfg = reduced(get_config("stablelm-12b"), n_layers=3)
    params = numpy_params(ref_cfg)
    model = convert.from_reference(params, cfg, device="cpu")
    back = convert.to_reference(model)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(leaf), flat_b[path])


def test_from_reference_rejects_a_misshapen_leaf():
    ref_cfg = ref_reduced(ref_get_config("qwen2-0.5b"))
    params = numpy_params(ref_cfg)
    params["final_norm"]["scale"] = params["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm.scale"):
        convert.from_reference(params, reduced(get_config("qwen2-0.5b")),
                               device="cpu")


def test_cast_weights_once_keeps_norms_in_fp32():
    cfg = reduced(get_config("stablelm-12b"))
    model = LM.init(cfg, seed=0, device="cpu").cast_weights_(torch.bfloat16)
    assert model.embed.dtype == torch.bfloat16
    blk = model.stack.blocks[0]
    assert blk.attn.wq.dtype == torch.bfloat16
    assert blk.mlp.wi.dtype == torch.bfloat16
    assert blk.norm1.scale.dtype == torch.float32
    assert model.final_norm.scale.dtype == torch.float32


def test_lm_init_defaults_to_cuda_and_raises_without_one():
    cfg = reduced(get_config("qwen2-0.5b"))
    if torch.cuda.is_available():
        assert LM.init(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            LM.init(cfg)
    a, b = LM.init(cfg, seed=3, device="cpu"), LM.init(cfg, seed=3,
                                                      device="cpu")
    assert torch.equal(a.embed, b.embed)
    assert torch.equal(a.stack.blocks[1].mlp.wo, b.stack.blocks[1].mlp.wo)


class _Wide:
    """A fake ``(data, model) = (1, 2)`` mesh seen from model rank
    ``rank``."""
    mesh_dim_names = ("data", "model")
    mesh = torch.zeros(1, 2)

    def __init__(self, rank=0):
        self.rank = rank

    def get_local_rank(self, axis):
        return self.rank if axis == "model" else 0


def _rank_ctxs(mesh):
    """Both ranks of a ``(1, 2)`` model axis in one process: each a
    ``ParallelCtx`` of ``_Wide(r)`` whose tp group is ``mesh``'s one-rank
    group, so its *copy* and *reduce* leave a rank's partial result as it
    is and the two ranks' results sum to the whole."""
    from repro_torch.core import hierarchy
    from repro_torch.models.transformer import ParallelCtx
    group = hierarchy.axis_group(mesh, ("model",), hierarchy.Traffic())
    out = []
    for r in (0, 1):
        pctx = ParallelCtx(mesh=_Wide(r))
        pctx._memo["tp_group"] = group
        out.append(pctx)
    return out


@pytest.mark.parametrize("arch,item", [
    ("mamba2-780m", "ssd"), ("recurrentgemma-2b", "rglru"),
    ("moonshot-v1-16b-a3b", "MoE")])
def test_unported_blocks_raise_naming_the_roadmap(arch, item):
    """Every block kind builds and trains: the ssd blocks through SSDFn (the
    hand-written SSD backward), the rglru blocks through RGLRUFn (the
    hand-written RG-LRU backward), MoE FFNs through ``models.moe``.  MoE's
    expert parallelism (``apply_moe(impl="ep")``) needs a mesh's tp axis.
    The RG-LRU block is tensor-parallel: on a one-rank ``(data, model)``
    mesh its prefill (output and caches) is the plain block's bit for bit;
    on a ``(1, 2)`` model axis each rank's mixer on its channels gives a
    partial output, the two summing to the plain mixer's, and its state
    piece; the layout uses its leaves as their pieces."""
    from repro_torch.launch.mesh import one_rank
    from repro_torch.models import rglru
    from repro_torch.models.transformer import ParallelCtx, RunCtx
    from repro_torch.train import sharding
    cfg = reduced(get_config(arch))
    model = LM.init(cfg, device="cpu")
    if item == "MoE":
        x = torch.zeros((1, 4, cfg.d_model))
        with pytest.raises(ValueError, match="tp axis"):
            moe.apply_moe(model.stack.blocks[0].moe, x, cfg, impl="ep")
    if item == "rglru":
        f32 = torch.float32
        blk = model.stack.blocks[0]
        x = torch.randn((2, 6, cfg.d_model),
                        generator=torch.Generator().manual_seed(0))
        pos = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
        want, want_c, _ = blk(x, RunCtx(compute_dtype=f32), positions=pos,
                              cache="init")
        h = blk.norm1(x)
        mix, mix_c = rglru.apply_rglru(blk.rglru, h, cfg, compute_dtype=f32,
                                       build_cache=True)
        with one_rank(device="cpu") as mesh:
            got, got_c, _ = blk(x, RunCtx(compute_dtype=f32,
                                          pctx=ParallelCtx(mesh=mesh)),
                                positions=pos, cache="init")
            assert torch.equal(got, want)
            for n in want_c:
                assert torch.equal(got_c[n], want_c[n]), n
            parts = [rglru.apply_rglru(blk.rglru, h, cfg, compute_dtype=f32,
                                       build_cache=True, pctx=pctx)
                     for pctx in _rank_ctxs(mesh)]
        torch.testing.assert_close(parts[0][0] + parts[1][0], mix,
                                   atol=1e-6, rtol=1e-6)
        for n in ("conv", "state"):
            torch.testing.assert_close(
                torch.cat([c[n] for _, c in parts], dim=-1), mix_c[n],
                atol=1e-6, rtol=1e-6)
        layout = sharding.Layout(cfg, PolicyConfig(), _Wide())
        assert layout.use_specs["stack.blocks.0.rglru.in_rec"] == (
            None, "model")
        assert "stack.blocks.0.rglru.wa" in layout.partial
    policy = PolicyConfig(compute_dtype="float32")
    assert callable(trainer.make_train_step(cfg, policy))


@torch.no_grad()
def test_unported_attention_paths_raise_naming_the_roadmap():
    """The sliding-window paths are ported, and so are the tensor-parallel
    ones: on a one-rank ``(data, model)`` mesh a block's TP prefill and the
    paged decode over the pool equal the plain ones at 1e-6; on a ``(1,
    2)`` model axis each rank's windowed prefill and paged decode (its
    heads, its pool's KV heads) give partial outputs that sum to the plain
    path's.  MoE on a mesh without the tp axis takes the sorted path."""
    from repro_torch.launch.mesh import one_rank
    from repro_torch.models.transformer import ParallelCtx
    cfg = dataclasses.replace(reduced(get_config("qwen2-0.5b")),
                              block_pattern=("attn_local",) * 2)
    LM.init(cfg, device="cpu")
    base = reduced(get_config("qwen2-0.5b"))
    model = LM.init(base, device="cpu")
    attn = model.stack.blocks[0].attn
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 4, base.d_model), generator=gen)
    pos = torch.arange(4, dtype=torch.int32)[None]
    f32 = torch.float32
    out, _ = attention.apply_attention(attn, x, base, local=True,
                                       positions=pos, compute_dtype=f32)
    assert out.shape == x.shape
    want, _ = attention.apply_attention(attn, x, base, local=False,
                                        positions=pos, compute_dtype=f32)
    # a pool of 3 pages of 4 tokens (and the scratch page): one row of 6
    # tokens over pages 2 and 0, its new token at position 6
    K, D = base.n_kv_heads, base.head_dim
    pool_k, pool_v = (torch.randn((4, 4, K, D), generator=gen)
                      for _ in range(2))
    pool_pos = torch.full((4, 4), -1, dtype=torch.int32)
    pool_pos[2] = torch.arange(4)
    pool_pos[0, :2] = torch.tensor([4, 5])

    def paged(heads=slice(None)):
        return attention.PagedDecodeCache(
            k=pool_k[:, :, heads].clone(), v=pool_v[:, :, heads].clone(),
            pos=pool_pos.clone(), tables=torch.tensor([[2, 0]],
                                                      dtype=torch.int32),
            slot=torch.tensor([2]), new_pos=torch.tensor([6],
                                                         dtype=torch.int32),
            lengths=torch.tensor([7], dtype=torch.int32))

    x1, pos1 = x[:, :1], torch.tensor([[6]], dtype=torch.int32)
    want_paged, _ = attention.apply_attention(
        attn, x1, base, local=False, positions=pos1, cache=paged(),
        compute_dtype=f32)
    with one_rank(device="cpu") as mesh:
        got, _ = attention.apply_attention(
            attn, x, base, local=False, positions=pos, compute_dtype=f32,
            pctx=ParallelCtx(mesh=mesh))
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        got, _ = attention.apply_attention(
            attn, x1, base, local=False, positions=pos1, cache=paged(),
            compute_dtype=f32, pctx=ParallelCtx(mesh=mesh))
        torch.testing.assert_close(got, want_paged, atol=1e-6, rtol=1e-6)
        ranks = _rank_ctxs(mesh)
        assert attention.pool_kv_heads(base.n_heads, K, 2) == K // 2
        local = sum(attention.apply_attention(
            attn, x, base, local=True, positions=pos, compute_dtype=f32,
            pctx=pctx)[0] for pctx in ranks)
        split = sum(attention.apply_attention(
            attn, x1, base, local=False, positions=pos1,
            cache=paged(slice(r, r + 1)), compute_dtype=f32,
            pctx=pctx)[0] for r, pctx in enumerate(ranks))
    torch.testing.assert_close(local, out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(split, want_paged, atol=1e-6, rtol=1e-6)

    class DataOnly:
        mesh_dim_names = ("data",)
        mesh = torch.zeros(1)
    policy = PolicyConfig(compute_dtype="float32")
    assert not make_run_ctx(base, policy, mesh=DataOnly()).pctx.tp_on
    assert make_run_ctx(reduced(get_config("moonshot-v1-16b-a3b")), policy,
                        mesh=DataOnly()).moe_impl == "sorted"


def test_kernel_path_counts_no_launch_on_cpu():
    _, _, _, cfg, model, ctx = both("qwen2-0.5b", kernel=True)
    before = dict(ops.launch_counts())
    with torch.no_grad():
        model(torch.from_numpy(_tokens(cfg, 1, 8)), ctx)
    assert ops.launch_counts() == before
