"""Port vs reference: NVMe tranches and the storage half of the input
pipeline (``repro_torch/data/{storage,pipeline}.py`` against
``repro/data/...``).

The tranche pool's semantics (shared and exclusive leases, capacity, the
errors and their messages), its reports, the compositions that lease a
tranche, the DLIO-style I/O traces (seeded as the reference seeds them: the
same numbers), the storage pricing and stalls, and the prefetcher's batches.
Pricing reads the link table, so the reference's is fed to the port
(``ref_constants``); the deterministic outputs must then be byte-identical
(``canon``: ``json.dumps(..., sort_keys=True)``; both from
``tests/test_torch_topology.py``), and arrays equal element for element.
"""
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.core import compose as ref_compose
from repro.core import topology as ref_topology
from repro.data import pipeline as ref_pipeline
from repro.data import storage as ref_storage

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import compose, topology
from repro_torch.data import pipeline, storage

from test_torch_topology import canon, ref_constants  # noqa: F401


SIDES = {"ref": (ref_storage, ref_pipeline, ref_topology, ref_compose),
         "port": (storage, pipeline, topology, compose)}


def same(fn):
    ref, port = fn(*SIDES["ref"]), fn(*SIDES["port"])
    assert canon(port) == canon(ref)
    return port


def raises_same(fn):
    with pytest.raises(ref_compose.CompositionError) as r:
        fn(*SIDES["ref"])
    with pytest.raises(compose.CompositionError) as p:
        fn(*SIDES["port"])
    assert str(p.value) == str(r.value)


# ---------------------------------------------------------------------------
# tranches
# ---------------------------------------------------------------------------
def test_storage_pool_leases_and_reports(ref_constants):
    def run(st, pl, t, c):
        pool = st.make_storage_pool(3, 2, domains=2)
        f0 = "falcon-nvme-0"
        out = [pool.lease(f0, "a", capacity_bytes=1e12, now=3.0),
               pool.lease(f0, "b", capacity_bytes=2e12),
               pool.lease("local-nvme-1", "c", exclusive=True)]
        out += [pool.n_lessees(f0), pool.lessees(f0), pool.tranches_of("a"),
                pool.capacity_used(f0), pool.exclusively_held("local-nvme-1"),
                pool.read_bw(f0), pool.write_bw(f0),
                pool.read_bw("local-nvme-0"),
                pool.by_attach(t.LinkClass.SWITCH), pool.stats()]
        pool.check_invariants()
        out += [pool.release_tranche("a", f0), pool.release_tranche("a", f0),
                pool.release("b"), pool.release("b"), pool.stats()]
        return out
    same(run)


@pytest.mark.parametrize("case", ["unknown", "twice", "exclusive_held",
                                  "exclusive_claim", "capacity",
                                  "duplicate_names"])
def test_storage_errors_as_the_reference(case):
    def run(st, pl, t, c):
        if case == "duplicate_names":
            st.StoragePool([st.StorageTranche("x"), st.StorageTranche("x")])
        pool = st.make_storage_pool(2, 1)
        pool.lease("falcon-nvme-0", "a", capacity_bytes=3e12)
        if case == "unknown":
            pool.lease("nvme-9", "a")
        elif case == "twice":
            pool.lease("falcon-nvme-0", "a")
        elif case == "exclusive_held":
            pool.lease("local-nvme-0", "b", exclusive=True)
            pool.lease("local-nvme-0", "c")
        elif case == "exclusive_claim":
            pool.lease("falcon-nvme-0", "b", exclusive=True)
        else:
            pool.lease("falcon-nvme-0", "b", capacity_bytes=1.5e12)
    if case == "duplicate_names":
        with pytest.raises(ValueError) as r:
            run(*SIDES["ref"])
        with pytest.raises(ValueError) as p:
            run(*SIDES["port"])
        assert str(p.value) == str(r.value)
    else:
        raises_same(run)


def test_a_composition_leases_its_tranche_atomically(ref_constants):
    def run(st, pl, t, c):
        pool = t.make_pool(4, 4, pods=1)
        spool = st.make_storage_pool(1, 1)
        links = {"data": t.LinkClass.LOCAL}
        a = c.compose(pool, "a", ("data",), (2,), links, storage_pool=spool,
                      tranche="falcon-nvme-0", storage_capacity=1e12)
        spool.lease("local-nvme-0", "x", exclusive=True)
        try:
            c.compose(pool, "b", ("data",), (2,), links, storage_pool=spool,
                      tranche="local-nvme-0")
        except c.CompositionError as e:
            err = str(e)
        after = [dict(pool.leases), spool.stats()]
        a2 = c.recompose(pool, a, axis_sizes=(4,))
        c.release(pool, a2, storage_pool=spool)
        return [a, err, after, a2, dict(pool.leases), spool.stats()]
    same(run)


# ---------------------------------------------------------------------------
# I/O workloads and traces
# ---------------------------------------------------------------------------
def _lm_workloads(pl, get, shapes):
    return [pl.lm_io_workload(get(arch), shapes[s], samples_per_epoch=4096,
                              checkpoint_every=7)
            for arch in ("llama3.2-3b", "musicgen-large", "mamba2-780m")
            for s in ("train_4k", "prefill_32k", "decode_32k")]


def test_io_workloads_equal_the_reference():
    assert canon(pipeline.IO_WORKLOADS) == canon(ref_pipeline.IO_WORKLOADS)
    got = _lm_workloads(pipeline, get_config, SHAPES)
    want = _lm_workloads(ref_pipeline, ref_get_config, REF_SHAPES)
    assert canon(got) == canon(want)
    for w, rw in zip(list(pipeline.IO_WORKLOADS.values()) + got,
                     list(ref_pipeline.IO_WORKLOADS.values()) + want):
        assert (w.steps_per_epoch, w.mean_step_read_bytes(),
                w.mean_step_write_bytes(), w.dataset_bytes()) == \
            (rw.steps_per_epoch, rw.mean_step_read_bytes(),
             rw.mean_step_write_bytes(), rw.dataset_bytes())


@pytest.mark.parametrize("name", ["resnet50", "yolov5l", "bert-large",
                                  "lm"])
@pytest.mark.parametrize("seed", [0, 7])
def test_io_traces_are_the_reference_numbers(name, seed):
    if name == "lm":
        w, rw = (_lm_workloads(pipeline, get_config, SHAPES)[0],
                 _lm_workloads(ref_pipeline, ref_get_config, REF_SHAPES)[0])
    else:
        w, rw = pipeline.IO_WORKLOADS[name], ref_pipeline.IO_WORKLOADS[name]
    gen = pipeline.IOTraceGenerator(w, seed)
    ref = ref_pipeline.IOTraceGenerator(rw, seed)
    np.testing.assert_array_equal(gen.record_sizes(), ref.record_sizes())
    spe = w.steps_per_epoch
    for start in (0, spe - 3, 2 * spe - 1):       # across epoch boundaries
        np.testing.assert_array_equal(gen.read_trace(6, start),
                                      ref.read_trace(6, start))
    np.testing.assert_array_equal(gen.epoch_order(1), ref.epoch_order(1))
    for step in (0, spe - 1, spe, 3 * spe - 1):
        assert gen.step_write_bytes(step) == ref.step_write_bytes(step)


# ---------------------------------------------------------------------------
# pricing, stalls, prefetch
# ---------------------------------------------------------------------------
def _models(st, pl, t):
    spool = st.make_storage_pool(2, 1)
    spool.lease("falcon-nvme-0", "a")
    spool.lease("falcon-nvme-0", "b")
    return [pl.StorageModel(t.LOCAL_NVME), pl.StorageModel(t.SWITCH_NVME),
            pl.StorageModel(t.SWITCH_NVME, n_lessees=3, write_bw=1e9),
            pl.StorageModel(t.StorageSpec("fast", 80e9, t.LinkClass.HOST)),
            pl.StorageModel.for_tranche(spool, "falcon-nvme-0"),
            pl.StorageModel.for_tranche(spool, "local-nvme-1")]


def test_storage_model_and_stalls(ref_constants):
    def run(st, pl, t, c):
        out = []
        for m in _models(st, pl, t):
            out += [m, [m.read_time(n) for n in (0.0, 1.0, 7e6, 3e9)],
                    [m.write_time(n) for n in (-1.0, 0.0, 5e8)]]
            for w in pl.IO_WORKLOADS.values():
                out += [pl.workload_stall(w, m, s, prefetch=p)
                        for s in (0.01, 0.2) for p in (0, 2)]
        out += [pl.input_stall(r, s, prefetch=p) for r in (0.1, 0.3)
                for s in (0.2,) for p in (0, 1)]
        return out
    same(run)


def test_prefetcher_yields_the_reference_batches(ref_constants):
    cfg, ref_cfg = get_config("llama3.2-3b"), ref_get_config("llama3.2-3b")
    shape = ShapeConfig("t", 64, 4, "train")
    from repro.configs.base import ShapeConfig as RefShape
    ref_shape = RefShape("t", 64, 4, "train")
    for shard, n_shards in ((0, 1), (1, 2)):
        pf = pipeline.Prefetcher(
            pipeline.SyntheticDataset(cfg, shape, seed=3),
            pipeline.StorageModel(topology.SWITCH_NVME), shard=shard,
            n_shards=n_shards)
        ref = ref_pipeline.Prefetcher(
            ref_pipeline.SyntheticDataset(ref_cfg, ref_shape, seed=3),
            ref_pipeline.StorageModel(ref_topology.SWITCH_NVME), shard=shard,
            n_shards=n_shards)
        assert pf.read_time_s == ref.read_time_s
        assert iter(pf) is pf
        for _ in range(3):
            got, want = next(pf), next(ref)
            assert sorted(got) == sorted(want)
            for k in got:
                assert isinstance(got[k], np.ndarray)
                np.testing.assert_array_equal(got[k], want[k])
