"""The port's page pool: the host-side behaviour of ``tests/test_serve.py``
(alloc/free, exhaustion, prefix hits that verify tokens, live pages leaving
the eviction LRU, LRU eviction) re-run on ``repro_torch``, and the device-side
views (gather / scatter) held against the reference's on the same numpy data
(exact: they only move values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import transformer as ref_transformer
from repro.serve import kvcache as ref_kvcache

from repro_torch.configs import get_config, reduced
from repro_torch.serve import BlockTable, PageError, PagePool, kvcache


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config("qwen2-0.5b"))


def _prompt(seed: int, n: int, vocab: int):
    return list(np.random.RandomState(seed).randint(0, vocab, n))


def _pool(cfg, n_pages=12, page_size=8):
    return PagePool(cfg, n_pages=n_pages, page_size=page_size, device="cpu")


# ---------------------------------------------------------------------------
# host-side accounting
# ---------------------------------------------------------------------------
def test_pool_layout_is_per_layer_with_a_scratch_page(cfg):
    pool = _pool(cfg)
    assert len(pool.pages) == cfg.n_layers
    for layer in pool.pages:
        assert layer["k"].shape == (13, 8, cfg.n_kv_heads, cfg.head_dim)
        assert layer["v"].shape == layer["k"].shape
        assert layer["pos"].shape == (13, 8)
        assert layer["pos"].dtype == torch.int32
        assert (layer["pos"] == -1).all()
    assert pool.trash == 12


def test_page_alloc_free_recycles(cfg):
    pool = _pool(cfg)
    t, cached = pool.open_sequence(_prompt(0, 20, 100), max_new=4)
    assert cached == 0
    assert len(t) == pool.pages_for(24) == 3
    assert pool.in_use == 3
    pool.release(t)
    assert pool.in_use == 0 and len(t) == 0


def test_page_pool_exhaustion_raises(cfg):
    pool = _pool(cfg, n_pages=4)
    pool.open_sequence(_prompt(0, 20, 100), max_new=4)    # 3 pages
    with pytest.raises(PageError):
        pool.open_sequence(_prompt(1, 20, 100), max_new=4)
    assert pool.in_use == 3                   # failed open rolled back


def test_prefix_hash_hits_and_retention(cfg):
    pool = _pool(cfg)
    prompt = _prompt(7, 20, 100)              # 2 full pages + tail
    t1, c1 = pool.open_sequence(prompt, max_new=4)
    assert c1 == 0
    pool.close_sequence(prompt, t1)           # registers + retains
    t2, c2 = pool.open_sequence(prompt, max_new=4)
    assert c2 == 2 * pool.page_size           # both full pages reused
    assert pool.hit_tokens == 16
    other = _prompt(8, 20, 100)               # shares nothing
    _, c3 = pool.open_sequence(other, max_new=4)
    assert c3 == 0
    assert 0 < pool.hit_rate() < 1


def test_reused_prefix_page_is_not_evictable(cfg):
    pool = _pool(cfg, n_pages=6, page_size=8)
    prompt = _prompt(5, 17, 100)              # 3 pages, 2 hashable
    t1, _ = pool.open_sequence(prompt, max_new=4)
    pool.close_sequence(prompt, t1)           # 2 retained, 1 free
    t2, c2 = pool.open_sequence(prompt, max_new=4)   # reuse both pages
    assert c2 == 16
    assert not pool.retained                  # live pages left the LRU
    assert pool.in_use == 3                   # accounting sees them live
    with pytest.raises(PageError):            # only 3 pages truly free
        pool.open_sequence(_prompt(6, 28, 100), max_new=4)
    assert all(pool.ref[p] == 1 for p in t2.pages)


def test_prefix_hit_verifies_token_content(cfg):
    pool = _pool(cfg)
    prompt = _prompt(9, 20, 100)
    t1, _ = pool.open_sequence(prompt, max_new=4)
    pool.close_sequence(prompt, t1)
    page = next(p for p in range(pool.n_pages)
                if pool.page_hash[p] is not None)
    pool.page_key[page] = (0, ("collision",))    # same hash, other tokens
    _, cached = pool.open_sequence(prompt, max_new=4)
    assert cached == 0


def test_retained_pages_evicted_lru(cfg):
    pool = _pool(cfg, n_pages=6, page_size=8)
    p1 = _prompt(1, 17, 100)                  # 3 pages, 2 hashable
    t1, _ = pool.open_sequence(p1, max_new=4)
    pool.close_sequence(p1, t1)               # 2 retained + 1 free
    assert len(pool.retained) == 2
    p2 = _prompt(2, 40, 100)                  # needs 6 pages -> evicts
    t2, _ = pool.open_sequence(p2, max_new=4)
    assert len(t2) == 6 and pool.evictions >= 2


def test_recycled_pages_get_their_pos_rows_cleared(cfg):
    pool = _pool(cfg, n_pages=3, page_size=8)
    t, _ = pool.open_sequence(_prompt(0, 10, 100), max_new=2)
    for layer in pool.pages:
        layer["pos"][t.pages[0]] = torch.arange(8, dtype=torch.int32)
    pool.release(t)
    t2 = pool.allocate(3)
    for layer in pool.pages:
        assert (layer["pos"][t2] == -1).all()


def test_padded_table_and_stats(cfg):
    pool = _pool(cfg)
    t = BlockTable([3, 1])
    assert pool.padded_table(t, 4) == [3, 1, pool.trash, pool.trash]
    s = pool.stats()
    assert s["n_pages"] == 12 and s["page_size"] == 8 and s["in_use"] == 0


def test_pool_requires_an_all_attention_pattern():
    with pytest.raises(ValueError, match="all-'attn'"):
        PagePool(reduced(get_config("recurrentgemma-2b")), n_pages=4,
                 device="cpu")


def test_pool_defaults_to_cuda_and_raises_without_one(cfg):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagePool(cfg, n_pages=4)


# ---------------------------------------------------------------------------
# device-side views vs the reference
# ---------------------------------------------------------------------------
def _filled_pools(cfg, n_pages=6, ps=4, seed=0):
    """A port pool and the reference's pytree holding the same numbers."""
    ref_cfg = ref_reduced(ref_get_config("qwen2-0.5b"))
    segs = ref_transformer.plan_segments(ref_cfg.pattern)
    r = np.random.RandomState(seed)
    pool = PagePool(cfg, n_pages=n_pages, page_size=ps, device="cpu")
    L = cfg.n_layers
    shape = (L, n_pages + 1, ps, cfg.n_kv_heads, cfg.head_dim)
    k = r.standard_normal(shape).astype(np.float32)
    v = r.standard_normal(shape).astype(np.float32)
    pos = r.randint(-1, 20, (n_pages + 1, ps)).astype(np.int32)
    for i, layer in enumerate(pool.pages):
        layer["k"].copy_(torch.from_numpy(k[i]))
        layer["v"].copy_(torch.from_numpy(v[i]))
        layer["pos"].copy_(torch.from_numpy(pos))
    assert segs == [(("attn",), L)]           # one scanned segment: stacked
    ref_pages = {"seg0": {"slot0": {
        "k": jnp.asarray(k), "v": jnp.asarray(v),
        "pos": jnp.asarray(np.broadcast_to(pos, (L,) + pos.shape))}}}
    return pool, ref_pages, segs


def test_gather_dense_matches_reference(cfg):
    pool, ref_pages, segs = _filled_pools(cfg)
    tables = np.asarray([[2, 0, 6], [5, 1, 3]], np.int32)
    want = ref_kvcache.gather_dense(ref_pages, jnp.asarray(tables), segs)
    got = kvcache.gather_dense(pool.pages, torch.from_numpy(tables))
    for i, layer in enumerate(got):
        for name in ("k", "v", "pos"):
            np.testing.assert_array_equal(
                layer[name].numpy(),
                np.asarray(want["seg0"]["slot0"][name][i]))


def test_scatter_tokens_matches_reference(cfg):
    pool, ref_pages, segs = _filled_pools(cfg, seed=1)
    ps, L = pool.page_size, cfg.n_layers
    tables = np.asarray([[2, 0, 4], [5, 1, 3]], np.int32)
    positions = np.asarray([[3, 4, 5], [9, 10, 11]], np.int32)
    valid = np.asarray([[True, True, False], [True, False, False]])
    r = np.random.RandomState(2)
    dk = r.standard_normal((L, 2, 3 * ps, cfg.n_kv_heads,
                            cfg.head_dim)).astype(np.float32)
    dv = r.standard_normal(dk.shape).astype(np.float32)
    dpos = np.zeros((L, 2, 3 * ps), np.int32)
    want = ref_kvcache.scatter_tokens(
        ref_pages, {"seg0": {"slot0": {"k": jnp.asarray(dk),
                                       "v": jnp.asarray(dv),
                                       "pos": jnp.asarray(dpos)}}},
        jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(valid),
        ps, segs, pool.trash)
    dense = [{"k": torch.from_numpy(dk[i]), "v": torch.from_numpy(dv[i]),
              "pos": torch.from_numpy(dpos[i])} for i in range(L)]
    kvcache.scatter_tokens(pool.pages, dense, torch.from_numpy(tables),
                           torch.from_numpy(positions),
                           torch.from_numpy(valid), ps, pool.trash)
    live = list(range(pool.n_pages))     # the scratch page takes any write
    for i, layer in enumerate(pool.pages):
        for name in ("k", "v", "pos"):
            np.testing.assert_array_equal(
                layer[name][live].numpy(),
                np.asarray(want["seg0"]["slot0"][name][i])[live])
        assert (layer["pos"][pool.trash] <= 19).all()


def test_scatter_slot_writes_one_batch_slot(cfg):
    caches = [{"k": torch.zeros(3, 5, 2, 4), "v": torch.zeros(3, 5, 2, 4),
               "pos": torch.full((3, 5), -1, dtype=torch.int32)}]
    one = [{"k": torch.ones(1, 5, 2, 4), "v": 2 * torch.ones(1, 5, 2, 4),
            "pos": torch.arange(5, dtype=torch.int32)[None]}]
    kvcache.scatter_slot(caches, one, 1)
    assert (caches[0]["k"][1] == 1).all() and (caches[0]["k"][0] == 0).all()
    assert (caches[0]["v"][1] == 2).all() and (caches[0]["v"][2] == 0).all()
    assert caches[0]["pos"][1].tolist() == [0, 1, 2, 3, 4]
    assert (caches[0]["pos"][2] == -1).all()
