"""Port vs reference: the tuned-config registry and the autotuner
(``repro_torch/kernels/{registry,autotune}.py`` against
``repro/kernels/...``), and the dispatch's resolution of a ``None`` knob.

Keys, the registry's JSON, lookups, the four resolvers and
``kernel_speedups`` must equal the reference's exactly, with one registry
installed on both sides (``both``: the reference's ``get_registry()`` would
otherwise read its CPU-interpreter file ``results/tuned_configs.json``;
both are reset after each test, since a worker runs many files in one
process).  The candidates of the decode and RG-LRU cells follow the
reference's rules; the flash, flash-backward and SSD cells have the one
candidate their design launches.  The sweep runs here on the plain versions
(``device="cpu"``); on the card ``chip_smoke.py``'s ``tune`` line runs it.
PyTorch runs on one thread (a module fixture, as in the other port tests).
"""
import json

import pytest
import torch

from repro.kernels import autotune as ref_at
from repro.kernels import registry as ref_reg

from repro_torch.kernels import autotune as at
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import registry as reg
from repro_torch.kernels import rglru as rg
from repro_torch.kernels import ssd as sd
from repro_torch.kernels.flash_attention import tile


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_registry():
    """Every test starts and ends with no registry installed on either
    side."""
    reg.reset_registry()
    ref_reg.reset_registry()
    yield
    reg.reset_registry()
    ref_reg.reset_registry()


# entries on a few cells of every kernel, and one with no measurement
ENTRIES = {
    ("decode_attention", "bfloat16", "causal",
     (("b", 8), ("d", 128), ("g", 3), ("t", 2048))):
        ({"block_q": 1, "block_k": 64}, 20.0, 25.0),
    ("decode_attention", "bfloat16", "causal",
     (("b", 1), ("d", 128), ("g", 3), ("t", 256))):
        ({"block_q": 1, "block_k": 32}, 8.0, 9.0),
    ("flash_attention", "bfloat16", "causal",
     (("d", 128), ("g", 3), ("s", 2048), ("t", 2048))):
        ({"block_q": 128, "block_k": 128}, 75.0, 75.0),
    ("flash_attention_bwd", "float32", "window",
     (("d", 64), ("g", 2), ("s", 256), ("t", 256))):
        ({"block_q": 64, "block_k": 32}, 0.0, 10.0),
    ("ssd", "float32", "",
     (("g", 1), ("h", 4), ("n", 32), ("p", 16), ("s", 128))):
        ({"chunk": 32}, 50.0, 60.0),
    ("rglru", "float32", "", (("s", 4096), ("w", 2560))):
        ({"block_seq": 128}, 70.0, 84.0),
    ("rglru", "float32", "", (("s", 128), ("w", 64))):
        ({"block_seq": 16}, 3.0, 4.5),
}


def _registries():
    mine, ref = reg.Registry(), ref_reg.Registry()
    for (kernel, dtype, variant, dims), (blocks, us, dus) in ENTRIES.items():
        key = reg.make_key(kernel, dtype=dtype, variant=variant, **dict(dims))
        mine.put(key, reg.TunedEntry(dict(blocks), us, dus, 5, "card"))
        ref.put(key, ref_reg.TunedEntry(dict(blocks), us, dus, 5, "card"))
    return mine, ref


@pytest.fixture
def both():
    """The same registry installed on both sides."""
    mine, ref = _registries()
    reg.set_registry(mine)
    ref_reg.set_registry(ref)
    return mine, ref


# ---------------------------------------------------------------------------
# keys, buckets, entries, files
# ---------------------------------------------------------------------------
KEY_CELLS = [
    ("flash_attention", "float32", "causal", dict(s=384, t=384, d=64, g=4)),
    ("flash_attention_bwd", "bfloat16", "window",
     dict(s=4096, t=4096, d=256, g=10)),
    ("decode_attention", "bfloat16", "causal", dict(b=3, t=1000, d=160,
                                                    g=4)),
    ("decode_attention", "float32", "causal", dict(b=1, t=16, d=32, g=1)),
    ("ssd", "bfloat16", "", dict(s=2000, h=48, p=64, g=1, n=128)),
    ("rglru", "float32", "", dict(s=7, w=2560)),
]


@pytest.mark.parametrize("kernel,dtype,variant,dims", KEY_CELLS)
def test_make_key_equals_the_reference(kernel, dtype, variant, dims):
    assert reg.make_key(kernel, dtype=dtype, variant=variant, **dims) == \
        ref_reg.make_key(kernel, dtype=dtype, variant=variant, **dims)


def test_bucket_floors_and_fit_block_equal_the_reference():
    assert reg._BUCKET_FLOOR == ref_reg._BUCKET_FLOOR
    for n in (1, 2, 3, 31, 32, 33, 100, 1024, 1025):
        for floor in (1, 16, 32):
            assert reg.bucket_pow2(n, floor) == ref_reg.bucket_pow2(n, floor)
    for block in (1, 16, 64, 100, 128, 256, 512):
        for dim in (1, 7, 40, 48, 192, 200, 768, 1000, 4096):
            assert reg.fit_block(block, dim) == ref_reg.fit_block(block, dim)


def test_dtype_names_are_the_reference_names():
    assert reg._dtype_name(torch.float32) == "float32"
    assert reg._dtype_name(torch.bfloat16) == "bfloat16"
    assert reg._dtype_name("float32") == ref_reg._dtype_name("float32")


def test_tuned_entry_json_equals_the_reference():
    for blocks, us, dus in ENTRIES.values():
        mine = reg.TunedEntry(dict(blocks), us, dus, 3, "cpu")
        ref = ref_reg.TunedEntry(dict(blocks), us, dus, 3, "cpu")
        assert mine.to_json() == ref.to_json()
        assert mine.speedup == ref.speedup
        back = reg.TunedEntry.from_json(json.loads(json.dumps(
            mine.to_json())))
        assert back == mine


def test_save_gives_the_reference_bytes_and_loads_back(tmp_path):
    mine, ref = _registries()
    a = mine.save(str(tmp_path / "port" / "tuned.json"))
    b = ref.save(str(tmp_path / "ref" / "tuned.json"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    back = reg.Registry.load(a)
    assert back.path == a and len(back) == len(mine)
    assert {k: e.to_json() for k, e in back.entries.items()} == \
        {k: e.to_json() for k, e in mine.entries.items()}


def test_lookup_hit_and_miss_equal_the_reference():
    mine, ref = _registries()
    for kernel, dtype, variant, dims in list(ENTRIES) + [
            ("decode_attention", "bfloat16", "causal",
             (("b", 2), ("d", 128), ("g", 3), ("t", 2048)))]:
        defaults = {"block_q": 7, "block_k": 9, "chunk": 5, "block_seq": 3}
        got = mine.lookup(kernel, defaults, dtype=dtype, variant=variant,
                          **dict(dims))
        assert got == ref.lookup(kernel, defaults, dtype=dtype,
                                 variant=variant, **dict(dims))
        hit = (kernel, dtype, variant, dims) in ENTRIES
        assert (got != defaults) == hit


# ---------------------------------------------------------------------------
# the resolvers and the speedups, one registry on both sides
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("installed", [False, True])
def test_resolvers_equal_the_reference(request, installed):
    if installed:
        request.getfixturevalue("both")
    else:                  # the reference's would read its CPU file
        reg.set_registry(None)
        ref_reg.set_registry(None)
    n = 0
    for dt, name in ((torch.float32, "float32"),
                     (torch.bfloat16, "bfloat16")):
        for S in (1, 40, 128, 200, 256, 2048, 4096):
            for D, G in ((64, 2), (128, 3), (256, 10)):
                for causal, window in ((True, 0), (False, 0), (True, 64)):
                    for kernel in ("flash_attention", "flash_attention_bwd"):
                        assert reg.attention_blocks(
                            S, S, D, G, dt, causal, window, (128, 64),
                            kernel) == ref_reg.attention_blocks(
                            S, S, D, G, name, causal, window, (128, 64),
                            kernel)
                        n += 1
            for W in (64, 2560):
                assert reg.rglru_block(S, W, dt, 64) == \
                    ref_reg.rglru_block(S, W, name, 64)
            assert reg.ssd_chunk(S, 4, 16, 1, 32, dt) == \
                ref_reg.ssd_chunk(S, 4, 16, 1, 32, name)
        for B in (1, 3, 8):
            for T in (16, 48, 256, 2000, 2048):
                assert reg.decode_attention_blocks(
                    B, T, 128, 3, dt, defaults=(1, 128)) == \
                    ref_reg.decode_attention_blocks(
                        B, T, 128, 3, name, defaults=(1, 128))
    assert n > 0


def test_kernel_speedups_equal_the_reference(both):
    mine, ref = both
    assert reg.kernel_speedups() == ref_reg.kernel_speedups()
    assert reg.kernel_speedups(mine) == ref_reg.kernel_speedups(ref)
    assert reg.kernel_speedups()["decode_attention"] == \
        pytest.approx((25 / 20 + 9 / 8) / 2)
    reg.set_registry(None)
    assert reg.kernel_speedups() == {}


# ---------------------------------------------------------------------------
# where the registry comes from
# ---------------------------------------------------------------------------
def test_get_registry_reads_only_the_port_variable(tmp_path, monkeypatch):
    """Not ``$REPRO_TUNED_CONFIGS`` and not the reference's default file
    (``results/tuned_configs.json``, under the repository root where the
    tests run); ``$REPRO_TORCH_TUNED_CONFIGS`` when set; a malformed file
    behaves as untuned."""
    mine, _ = _registries()
    good = mine.save(str(tmp_path / "good.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.delenv(reg.ENV_VAR, raising=False)
    monkeypatch.setenv("REPRO_TUNED_CONFIGS", good)
    assert reg.get_registry() is None
    reg.reset_registry()
    monkeypatch.delenv("REPRO_TUNED_CONFIGS")
    monkeypatch.chdir(tmp_path)
    (tmp_path / "results").mkdir()
    mine.save(str(tmp_path / "results" / "tuned_configs.json"))
    mine.save(str(tmp_path / reg.DEFAULT_PATH))
    assert reg.get_registry() is None
    reg.reset_registry()
    monkeypatch.setenv(reg.ENV_VAR, good)
    got = reg.get_registry()
    assert got is not None and got.path == good and len(got) == len(mine)
    reg.reset_registry()
    monkeypatch.setenv(reg.ENV_VAR, str(bad))
    assert reg.get_registry() is None
    reg.set_registry(mine)                  # set_registry comes first
    assert reg.get_registry() is mine


# ---------------------------------------------------------------------------
# cases and candidates
# ---------------------------------------------------------------------------
def _case_pairs():
    yield (at.attn_case("flash_attention", S=384, D=64, G=4, window=128),
           ref_at.attn_case("flash_attention", S=384, D=64, G=4,
                            window=128))
    yield (at.attn_case("flash_attention_bwd", S=256, T=512, D=128, G=3,
                        dtype="bfloat16", causal=False, kv_heads=8),
           ref_at.attn_case("flash_attention_bwd", S=256, T=512, D=128, G=3,
                            dtype="bfloat16", causal=False))
    yield (at.decode_case(B=5, T=1024, D=160, G=4, dtype="bfloat16"),
           ref_at.decode_case(B=5, T=1024, D=160, G=4, dtype="bfloat16"))
    yield (at.ssd_case(S=2048, H=48, P=64, G=1, N=128, dtype="bfloat16"),
           ref_at.ssd_case(S=2048, H=48, P=64, G=1, N=128,
                           dtype="bfloat16"))
    yield at.rglru_case(S=300, W=2560), ref_at.rglru_case(S=300, W=2560)


@pytest.mark.parametrize("i", range(5))
def test_case_key_label_variant_equal_the_reference(i):
    mine, ref = list(_case_pairs())[i]
    assert (mine.key, mine.label(), mine.variant) == \
        (ref.key, ref.label(), ref.variant)


def test_kv_heads_is_outside_the_key():
    a = at.decode_case(B=8, T=2048, D=128, G=3, kv_heads=8)
    b = at.decode_case(B=8, T=2048, D=128, G=3, kv_heads=2)
    assert a.key == b.key and a != b


def test_decode_and_rglru_candidates_follow_the_reference():
    for B in (1, 8):
        for ps in (8, 16, 32):
            for P in (1, 2, 3, 4, 6, 8, 12, 16, 100, 128):
                mine = at.decode_case(B=B, T=P * ps, page_size=ps)
                ref = ref_at.decode_case(B=B, T=P * ps, page_size=ps)
                assert at.candidates_for(mine) == ref_at.candidates_for(ref)
    for S in (1, 16, 40, 64, 96, 128, 300, 1024, 4096):
        assert at.candidates_for(at.rglru_case(S=S)) == \
            ref_at.candidates_for(ref_at.rglru_case(S=S))
    assert [c["block_k"] for c in at.candidates_for(
        at.decode_case(B=8, T=2048, page_size=16))] == [16, 32, 64, 128, 256]


@pytest.mark.parametrize("case,want", [
    (at.attn_case("flash_attention", S=2048, D=128, G=3,
                  dtype="bfloat16"), {"block_q": 128, "block_k": 128}),
    (at.attn_case("flash_attention_bwd", S=4096, D=256, G=10,
                  dtype="bfloat16", window=2048),
     {"block_q": 128, "block_k": 64}),
    (at.attn_case("flash_attention", S=128, D=32, G=2, dtype="bfloat16"),
     {"block_q": 64, "block_k": 64}),
    (at.attn_case("flash_attention_bwd", S=128, D=160, G=2),
     {"block_q": 64, "block_k": 64}),
    (at.ssd_case(S=2048, H=48, P=64, G=1, N=128, dtype="bfloat16"),
     {"chunk": sd.KERNEL_CHUNK}),
])
def test_flash_and_ssd_cells_have_their_one_candidate(case, want):
    assert at.candidates_for(case) == [want]
    assert at.default_blocks(case) == want


def test_flash_attention_xla_has_no_counterpart():
    assert "flash_attention_xla" not in at.KERNELS
    assert set(at.KERNELS) < set(ref_at.KERNELS)
    with pytest.raises(ValueError, match="no counterpart"):
        at.candidates_for(at.attn_case("flash_attention_xla", S=256, D=64,
                                       G=4))


@pytest.mark.parametrize("case,want", [
    (at.decode_case(B=8, T=2048, page_size=16), {"block_q": 1,
                                                 "block_k": 128}),
    (at.decode_case(B=1, T=64, page_size=16), {"block_q": 1, "block_k": 64}),
    (at.decode_case(B=2, T=96, page_size=16), {"block_q": 1, "block_k": 96}),
    (at.decode_case(B=1, T=2048, page_size=256), {"block_q": 1,
                                                  "block_k": 256}),
    (at.rglru_case(S=4096, W=2560), {"block_seq": 64}),
    (at.rglru_case(S=40), {"block_seq": 40}),
])
def test_default_blocks_are_the_port_defaults(case, want):
    assert at.default_blocks(case) == want


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_attention_raises_on_a_tile_the_design_lacks():
    r = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, h, 32, generator=r) for h in (4, 2, 2))
    want = ops.attention(q, k, v)
    assert tile(32, torch.float32) == (64, 64)
    for bq, bk in ((64, 64), (64, None), (None, 64)):
        assert torch.equal(ops.attention(q, k, v, block_q=bq, block_k=bk),
                           want)
    for bq, bk in ((128, 64), (None, 128), (32, 32)):
        with pytest.raises(ValueError, match=r"\(64, 64\)"):
            ops.attention(q, k, v, block_q=bq, block_k=bk)
    q, k, v = (torch.randn(1, 64, h, 64, generator=r).bfloat16()
               for h in (4, 2, 2))
    with pytest.raises(ValueError, match=r"\(128, 128\)"):
        ops.attention(q, k, v, impl="plain", block_q=64)


def _paged(B=2, T=256, D=32, G=2, K=2, ps=16):
    r = torch.Generator().manual_seed(1)
    P = T // ps
    q = torch.randn(B, G * K, D, generator=r)
    kp = torch.randn(B * P + 1, ps, K, D, generator=r)
    vp = torch.randn(B * P + 1, ps, K, D, generator=r)
    tables = torch.arange(B * P, dtype=torch.int32).reshape(B, P)
    return q, kp, vp, tables, torch.tensor([T, T - 9], dtype=torch.int32)


def test_ops_resolve_a_none_knob_from_the_registry(monkeypatch):
    seen = {}

    def spy(name, real):
        def f(*a, **kw):
            seen[name] = kw
            return real(*a, **kw)
        return f

    monkeypatch.setattr(pa, "paged_decode_attention",
                        spy("paged", pa.paged_decode_attention))
    monkeypatch.setattr(rg, "rglru", spy("rglru", rg.rglru))
    monkeypatch.setattr(sd, "ssd", spy("ssd", sd.ssd))
    paged = _paged()
    la, g = -torch.rand(1, 128, 64), torch.randn(1, 128, 64)
    x = torch.randn(1, 128, 4, 16)
    dt, A = torch.rand(1, 128, 4), -torch.rand(4)
    Bm, Cm = torch.randn(1, 128, 1, 32), torch.randn(1, 128, 1, 32)

    def run(paged=paged, la=la, g=g):
        ops.paged_attention(*paged)
        ops.rglru(la, g)
        ops.ssd(x, dt, A, Bm, Cm)
        return (seen["paged"]["block_k"], seen["rglru"]["chunk"],
                seen["ssd"]["chunk"])

    reg.set_registry(None)
    assert run() == (pa.PIECE_TOKENS, rg.CHUNK, sd.CHUNK)
    mine, _ = _registries()
    key = reg.make_key("decode_attention", dtype="float32",
                       variant="causal", b=2, d=32, g=2, t=256)
    mine.put(key, reg.TunedEntry({"block_q": 1, "block_k": 32}, 1, 2))
    reg.set_registry(mine)
    assert run() == (32, 16, 32)           # the ENTRIES' rglru and ssd cells
    reg.set_registry(reg.Registry())        # a registry that misses
    assert run() == (pa.PIECE_TOKENS, rg.CHUNK, sd.CHUNK)
    # explicit knobs pass through; rglru's is fitted to whole 16-step loads
    ops.paged_attention(*paged, block_k=64)
    ops.rglru(la, g, block_seq=40)
    assert (seen["paged"]["block_k"], seen["rglru"]["chunk"]) == (64, 32)


@pytest.mark.parametrize("S", [97, 100, 3000])
def test_a_miss_or_a_hit_is_not_fitted_to_the_shape(S):
    """The port's kernels take any S and cut whole pages themselves: a miss
    gives the port's default and a hit the registry's value, where the
    reference's resolvers fit both to divide S or T."""
    mine, _ = _registries()       # rglru (4096, 2560) holds 128 steps
    key = reg.make_key("decode_attention", dtype="bfloat16",
                       variant="causal", b=4, d=128, g=3, t=2048)
    mine.put(key, reg.TunedEntry({"block_q": 1, "block_k": 256}, 1, 2))
    reg.set_registry(mine)
    hit = S == 3000                        # bucket 4096 at W = 2560
    assert ops.rglru_chunk(S, 2560, torch.float32) == (128 if hit else 64)
    assert ops.rglru_chunk(S, 32, torch.float32) == rg.CHUNK
    assert reg.rglru_block(S, 2560, torch.float32, 64) == \
        reg.fit_block(128 if hit else 64, S)
    T = 16 * S                             # tables of S pages of 16
    want = 256 if 1024 < T <= 2048 else pa.PIECE_TOKENS
    assert ops.piece_tokens(3, T, 128, 3, torch.bfloat16) == want
    assert ops.piece_tokens(3, 16 * 97, 128, 3, torch.float32) == \
        pa.PIECE_TOKENS
    # the ENTRIES' ssd cell (s = 128) holds 32, given unfitted at S = 97
    assert ops.ssd_chunk(S, 4, 16, 1, 32, torch.float32) == \
        (sd.CHUNK if hit else 32)
    assert ops.ssd_chunk(S, 4, 16, 1, 64, torch.float32) == sd.CHUNK


def test_served_lengths_spread_below_the_bucket():
    for B in (1, 2, 4, 8):
        for T in (16, 256, 2048):
            ls = at.served_lengths(B, T)
            assert len(ls) == B and min(ls) >= 1
            assert list(ls) == sorted(ls, reverse=True)
            assert T // 2 < ls[0] <= T or T == 16
    assert at.served_lengths(8, 2048) == (1536, 1344, 1152, 960, 768, 576,
                                          384, 192)


def test_decode_cells_cycle_their_recorded_lengths():
    sets = ((100, 0, 7, 64), (33, 18, 1, 0))
    c = at.decode_case(B=4, T=128, lengths=sets)
    assert c.key == at.decode_case(B=4, T=128).key and c.lengths == sets
    for seed in range(4):
        got = at.build_call(c, {"block_q": 1, "block_k": 32}, device="cpu",
                            seed=seed)[1][4]
        assert tuple(got.tolist()) == sets[seed % 2]
    plain = at.build_call(at.decode_case(B=4, T=128), {"block_k": 32},
                          device="cpu")[1][4]
    assert tuple(plain.tolist()) == at.served_lengths(4, 128)
    with pytest.raises(AssertionError):
        at.decode_case(B=4, T=128, lengths=((200, 1, 1, 1),))


def test_every_input_set_is_held_to_the_plain_version(monkeypatch):
    """A candidate wrong only on the second set of row lengths fails."""
    real = at.build_call

    def wrong(case, blocks, **kw):
        fn, args = real(case, blocks, **kw)
        if blocks["block_k"] == 64:
            return (lambda q, kp, vp, t, ls: fn(q, kp, vp, t, ls)
                    * (1.001 if int(ls[0]) == 33 else 1.0)), args
        return fn, args

    monkeypatch.setattr(at, "build_call", wrong)
    res = at.tune_case(at.decode_case(B=2, T=128, lengths=((100, 7),)),
                       iters=1, device="cpu")
    assert len(res.timings) == 4
    with pytest.raises(RuntimeError, match="block_k': 64"):
        at.tune_case(at.decode_case(B=2, T=128,
                                    lengths=((100, 7), (33, 18))),
                     iters=1, device="cpu")


def test_paged_and_rglru_wrappers_refuse_what_the_kernels_lack():
    paged = _paged(ps=16)
    with pytest.raises(ValueError, match="no whole page"):
        pa.paged_decode_attention(*paged, block_k=8)
    with pytest.raises(ValueError, match="at most 128"):
        pa.split_pieces(4096, 1, 256)
    la, g = -torch.rand(1, 64, 8), torch.randn(1, 64, 8)
    for chunk in (8, 24, 272):
        with pytest.raises(ValueError, match="multiple of 16"):
            rg.rglru(la, g, chunk=chunk)
    assert [rg.fit_chunk(b) for b in (1, 16, 40, 64, 100, 256, 512)] == \
        [16, 16, 32, 64, 96, 256, 256]


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------
def test_tune_writes_merges_and_reloads_a_registry(tmp_path):
    path = str(tmp_path / "tuned.json")
    first, res = at.sweep(at.SMOKE_CASES[:4], iters=1, path=path,
                          device="cpu")
    assert reg.get_registry() is first      # installed in this process
    assert [r.case.key for r in res] == [c.key for c in at.SMOKE_CASES[:4]]
    for r in res:
        assert r.entry.backend == "cpu"
        assert r.entry.n_candidates == len(at.candidates_for(r.case))
        assert [b for b, _ in r.timings] == at.candidates_for(r.case)
        assert all(e["max_abs_err"] <= 1e-5 for e in r.errors)
        assert r.entry.blocks in at.candidates_for(r.case)
        assert at.resolve(r.case) == r.entry.blocks
        js = r.to_json()
        assert js["key"] == r.case.key and len(js["candidates"]) == \
            r.entry.n_candidates
    second, _ = at.sweep(at.SMOKE_CASES[4:], iters=1, path=path,
                         device="cpu")
    back = reg.Registry.load(path)
    assert sorted(back.entries) == sorted(c.key for c in at.SMOKE_CASES)
    assert sorted(second.entries) == sorted(back.entries)
    assert back.get(at.SMOKE_CASES[0].key).to_json() == \
        first.get(at.SMOKE_CASES[0].key).to_json()
    # the reference reads the port's file as its own
    assert sorted(ref_reg.Registry.load(path).entries) == \
        sorted(back.entries)


def test_a_wrong_candidate_fails_the_sweep(monkeypatch):
    real = at.build_call

    def wrong(case, blocks, **kw):
        fn, args = real(case, blocks, **kw)
        if blocks["block_seq"] == 32:
            return (lambda *a: fn(*a) * 1.001), args
        return fn, args

    monkeypatch.setattr(at, "build_call", wrong)
    with pytest.raises(RuntimeError, match="block_seq': 32"):
        at.tune([at.rglru_case(S=128, W=64)], iters=1, device="cpu")


def test_tune_without_a_device_argument_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: at.tune(at.SMOKE_CASES[:1]),
                 lambda: at.sweep(at.SMOKE_CASES[:1]),
                 lambda: at.main(["--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_default_cases_cover_the_served_decode_keys():
    """llama3.2-3b's paged engine (8 slots x 2048, page 16) captures a
    decode graph at every row bucket 1-8 and table width 1-128 pages: each
    has its cell, at the served head layout."""
    keys = {c.key for c in at.DEFAULT_CASES}
    for B in (1, 2, 4, 8):
        for P in (1, 2, 4, 8, 16, 32, 64, 128):
            assert reg.make_key("decode_attention", dtype="bfloat16",
                                variant="causal", b=B, d=128, g=3,
                                t=16 * P) in keys
    kinds = {c.kernel for c in at.DEFAULT_CASES}
    assert kinds == set(at.KERNELS)
    for c in at.DEFAULT_CASES:
        assert at.candidates_for(c)
