"""Port vs reference: elastic execution (``repro_torch/train/elastic.py``
against ``repro/train/elastic.py``), and a failure and resume that lands
bit for bit on the uninterrupted run.

The pool operations (a failure with spares, one that forces a shrink, a
preemption, a regrow) give the reference's events and compositions under
``ref_constants``; ``StragglerPolicy`` answers as the reference's.  The
reference resumes onto a ``jax`` mesh; the port restores in place onto the
device of the state it is handed and raises for a mesh.  On a reduced
``mamba2-780m`` (bf16 compute, fp32 parameters, AdamW), four steps straight
equal two steps, then ``save``, ``handle_failure``, ``resume`` into a state
built from another seed, and two more steps: losses, parameters, moments and
the optimizer step all bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import compose as ref_compose
from repro.core import topology as ref_topology
from repro.train import elastic as ref_elastic

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig, ShapeConfig
from repro_torch.core import compose, topology
from repro_torch.data import make_batch
from repro_torch.optim import AdamWConfig
from repro_torch.train import checkpoint, elastic, trainer

from test_torch_topology import canon, ref_constants  # noqa: F401

REF = (ref_elastic, ref_compose, ref_topology)
PORT = (elastic, compose, topology)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one CPU thread, as in ``tests/test_torch_moe.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_elastic_surface_is_the_reference_surface():
    for name in ("ElasticEvent", "ElasticRun", "handle_failure", "preempt",
                 "regrow", "resume", "StragglerPolicy"):
        assert hasattr(ref_elastic, name) and hasattr(elastic, name), name
    assert [f.name for f in dataclasses.fields(elastic.ElasticRun)] == \
        [f.name for f in dataclasses.fields(ref_elastic.ElasticRun)]


def _pool_story(el, cp, tp):
    """One composition through a failure with spares, a failure that
    forces a shrink, a preemption and a regrow after repair."""
    pool = tp.make_pool(8, 8, pods=2)
    L = tp.LinkClass
    sys_ = cp.compose(pool, "job", ("data", "model"), (4, 2),
                      {"data": L.SWITCH, "model": L.LOCAL})
    run = el.ElasticRun(sys_, ckpt_dir="/nonexistent")
    out = [sys_]
    out.append(el.handle_failure(run, pool, [sys_.device_uids[1]], step=3))
    # every spare and three of the job's devices gone: five are left for
    # a mesh of eight, so only a shrink of data fits
    gone = [d.uid for d in pool.available()] + list(
        run.system.device_uids[:3])
    out.append(el.handle_failure(run, pool, gone, step=7))
    el.preempt(run, pool, step=9)
    out.append(dict(pool.leases))
    pool.repair([d.uid for d in pool.devices])
    wide = cp.compose(pool, "job", ("data", "model"), (4, 2),
                      {"data": L.SWITCH, "model": L.LOCAL})
    out.append(el.regrow(run, wide, step=9))
    out.append(el.regrow(run, wide, step=10, detail="by hand"))
    try:
        el.handle_failure(run, pool, [d.uid for d in pool.devices], step=11)
    except Exception as e:                      # noqa: BLE001
        out.append(["raises", type(e).__name__, str(e)])
    out.append(run.events)
    return out


def test_pool_operations_log_the_reference_events(ref_constants):
    ref, port = _pool_story(*REF), _pool_story(*PORT)
    assert canon(port) == canon(ref)
    kinds = [e.kind for e in port[-1]]
    assert kinds == ["failure", "recompose", "failure", "recompose",
                     "preempt", "recompose", "recompose", "failure"]
    assert "shrunk data" in port[-1][3].detail
    assert port[-2][0] == "raises"


def test_straggler_policy_answers_as_the_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        kw = dict(deadline_factor=float(rng.uniform(1.0, 4.0)),
                  max_duplicates=int(rng.integers(0, 3)))
        a, b = ref_elastic.StragglerPolicy(**kw), elastic.StragglerPolicy(**kw)
        args = (float(rng.uniform(0, 10)), float(rng.uniform(0, 5)),
                int(rng.integers(0, 3)))
        assert a.should_duplicate(*args) == b.should_duplicate(*args)
        tail = (float(rng.uniform(0, 5)), float(rng.uniform(0, 20)))
        assert a.expected_tail_time(*tail) == b.expected_tail_time(*tail)
    assert elastic.StragglerPolicy().should_duplicate(0.0, 0.0, 0) is False


# ---------------------------------------------------------------------------
# a failure and resume through the trainer
# ---------------------------------------------------------------------------
SHAPE = ShapeConfig("t", 64, 2, "train")
POLICY = PolicyConfig(compute_dtype="bfloat16", param_dtype="float32",
                      remat="block", attn_impl="kernel", zero_stage=0)
OPT = AdamWConfig(lr=1e-3)


def _state(cfg, seed):
    return trainer.init_state(cfg, POLICY, OPT, seed=seed, device="cpu")


def _leaves(state):
    return checkpoint._leaves(state)


def test_failure_and_resume_equal_the_uninterrupted_run(tmp_path):
    cfg = reduced(get_config("mamba2-780m"))
    step_fn = trainer.make_train_step(cfg, POLICY, OPT)
    batches = [make_batch(cfg, SHAPE, step=i) for i in range(4)]

    a = _state(cfg, seed=0)
    losses_a = []
    for b in batches:
        a, m = step_fn(a, b)
        losses_a.append(m["loss"])

    pool = topology.make_pool(4, 4, pods=1)
    system = compose.compose(pool, "job", ("data", "model"), (1, 1),
                             {"data": topology.LinkClass.LOCAL,
                              "model": topology.LinkClass.LOCAL})
    run = elastic.ElasticRun(system, ckpt_dir=str(tmp_path / "ck"))
    b_state = _state(cfg, seed=0)
    losses_b = []
    for b in batches[:2]:
        b_state, m = step_fn(b_state, b)
        losses_b.append(m["loss"])
    checkpoint.save(run.ckpt_dir, 2, b_state)
    new = elastic.handle_failure(run, pool, system.device_uids, step=2)
    assert new.axis_sizes == (1, 1) and new.device_uids != system.device_uids
    del b_state
    fresh = _state(cfg, seed=5)
    assert not torch.equal(fresh.model.embed, a.model.embed)
    b_state, step = elastic.resume(run, fresh)
    assert step == 2 and b_state is fresh and b_state.opt.step == 2
    for b in batches[step:]:
        b_state, m = step_fn(b_state, b)
        losses_b.append(m["loss"])

    assert [e.kind for e in run.events] == ["failure", "recompose",
                                            "restore"]
    assert run.events[2].detail == "onto cpu" and run.events[2].step == 2
    for x, y in zip(losses_a, losses_b):
        assert torch.equal(x, y)
    la, lb = _leaves(a), _leaves(b_state)
    assert sorted(la) == sorted(lb)
    for k in la:
        if torch.is_tensor(la[k]):
            assert torch.equal(la[k], lb[k]), k
        else:
            assert la[k] == lb[k] == 4, k


def test_resume_raises_for_a_mesh(tmp_path):
    cfg = reduced(get_config("qwen2-0.5b"))
    policy = dataclasses.replace(POLICY, compute_dtype="float32")
    state = trainer.init_state(cfg, policy, OPT, seed=0, device="cpu")
    pool = topology.make_pool(2, 2, pods=1)
    system = compose.compose(pool, "job", ("data", "model"), (1, 1),
                             {"data": topology.LinkClass.LOCAL,
                              "model": topology.LinkClass.LOCAL})
    run = elastic.ElasticRun(system, ckpt_dir=str(tmp_path / "ck"))
    checkpoint.save(run.ckpt_dir, 1, state)
    # onto a mesh whose pieces this state does not hold (a one-rank view of
    # data = 2): the shapes refuse it, and no restore is logged
    specs = trainer.state_specs(state, cfg, dataclasses.replace(
        policy, zero_stage=3), {"data": 2})
    assert any("data" in s for s in specs.values())

    class Mesh:
        mesh_dim_names = ("data",)
        mesh = torch.zeros(2)

        @staticmethod
        def get_local_rank(axis):
            return 0

    with pytest.raises(ValueError, match="shape"):
        elastic.resume(run, state, mesh=Mesh, specs=specs)
    with pytest.raises(ValueError, match="specs without a mesh"):
        elastic.resume(run, state, specs=specs)
    assert run.events == []
    with pytest.raises(FileNotFoundError):
        elastic.resume(elastic.ElasticRun(system, str(tmp_path / "none")),
                       state)
