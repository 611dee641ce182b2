"""The data-parallel layer in four ``gloo`` processes on the CPU, held
against the reference: DP, ZeRO-1 and ZeRO-3 steps of reduced qwen2-0.5b
and mamba2-780m (the plain SSD on the CPU) against the reference's jitted
single-device step on the whole batch; the int8 error-feedback exchange on
``(pod, data) = (2, 2)`` against a host emulation built from the
reference's ``int8_encode`` / ``int8_decode`` (the reference's own pod
exchange does not run on XLA:CPU, ``tests/test_compress.py``); a
checkpoint saved on four ranks and resumed on two.

One group of four processes runs every job (``rehearse.four_ranks``) and
then the resume on its first two ranks, as a job's survivors go on; each
rank has a group timeout, the spawn a join timeout, and the rendezvous is
a file under ``tmp_path``.  The ranks import
neither JAX nor the reference: weights go in and parameters come out as
numpy arrays.

Tolerances, those of the single-device step tests
(``tests/test_torch_train.py``): loss and grad norm 1e-5 relative; updated
parameters 1e-6 where the reference's |g| > 1e-6 (read from its first
moment), else |difference| <= 2 lr.  ZeRO against DP, both on four
ranks: 1e-5 of each leaf's max-abs (the key bias, whose gradient the
softmax cancels, within 2 lr a step).  The int8 exchange inside the step,
against the reference's exchange emulated on the host: on the emulated
grid within 1e-3 of a step, the emulated value but at a rounding edge
(one step, at most 1e-4 of the elements), grad norm 1e-6 relative,
residuals 1e-5 of a leaf's max (or that and one step).
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import PolicyConfig as RefPolicy
from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro.train import trainer as ref_trainer

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.base import PolicyConfig
from repro_torch.configs.paper_bench import RESNET50
from repro_torch.core import compose
from repro_torch.core import policy as pol
from repro_torch.launch import rehearse
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.rehearse import Job
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig
from repro_torch.train import trainer

LR, WD = 1e-3, 0.1
ARCHS = ("qwen2-0.5b", "mamba2-780m")
JOBS = [Job(arch=a, zero=z, lr=LR) for a in ARCHS for z in (0, 1, 3)] + [
    Job(arch="qwen2-0.5b", zero=3, lr=LR, masked=True),
    Job(arch="qwen2-0.5b", zero=1, lr=LR, masked=True, grad_accum=2),
    Job(arch="qwen2-0.5b", zero=1, lr=LR, compression="int8_ef",
        mesh=(("pod", 2), ("data", 2)))]
SAVE_JOB = Job(arch="qwen2-0.5b", zero=3, steps=3, lr=LR)
SAVE_AT = 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_params(arch, seed=5):
    """The port's seed-``seed`` weights as the reference's pytree."""
    return convert.to_reference(LM.init(Job(arch=arch).cfg(), seed=seed,
                                        device="cpu"))


@pytest.fixture(scope="module")
def weights():
    return {a: _numpy_params(a) for a in ARCHS}


def _run_group(weights, ckpt, store):
    four = rehearse.spawn(rehearse.four_ranks, 4, JOBS, weights, str(ckpt),
                          SAVE_JOB, SAVE_AT, timeout=150, store_dir=store)
    saved = dict(np.load(ckpt / f"step_{SAVE_AT:010d}" / "arrays.npz"))
    return four, four[0]["resumed"], saved


@pytest.fixture(scope="module")
def launched(weights, tmp_path_factory):
    """The process group, started from a thread: it runs while this
    process computes the reference's steps."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    store = str(tmp_path_factory.mktemp("store"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(_run_group, weights, ckpt, store)


@pytest.fixture(scope="module")
def runs(launched, reference):
    """(the four ranks' results, rank 0's resume on the first two, the
    checkpoint's arrays).  ``reference`` first, so that both run at once."""
    return launched.result(timeout=300)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def reference(weights, launched):
    """(arch, masked, grad_accum) -> (params, metrics, first moments) of
    the reference's jitted step on the whole batch."""
    out = {}
    for job in JOBS:
        key = (job.arch, job.masked, job.grad_accum)
        if key in out:
            continue
        ref_cfg = ref_reduced(ref_get_config(job.arch))
        policy = RefPolicy(compute_dtype="float32", remat="block",
                           attn_impl="xla", zero_stage=0,
                           grad_accum=job.grad_accum)
        opt = ref_adamw.AdamWConfig(lr=LR, weight_decay=WD)
        jp = jax.tree.map(jnp.asarray, weights[job.arch])
        jb = {k: jnp.asarray(v) for k, v in job.batch_at(0).items()}
        state, m = jax.jit(ref_trainer.make_train_step(ref_cfg, policy, opt))(
            ref_trainer.TrainState(jp, ref_adamw.init(jp, opt)), jb)
        out[key] = (_flat(state.params), m, _flat(state.opt.m))
    return out


def _port_tree(job, params):
    """Parameter name -> array, as the reference's flat pytree."""
    model = LM(job.cfg(), device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(params[n]))
    return _flat(convert.to_reference(model))


def _job_result(runs, job):
    return runs[0][0]["train"][JOBS.index(job)]


@pytest.mark.parametrize("job", JOBS[:8], ids=lambda j: (
    f"{j.arch}-zero{j.zero}" + ("-masked" if j.masked else "")
    + (f"-accum{j.grad_accum}" if j.grad_accum > 1 else "")))
def test_step_on_four_ranks_matches_the_reference_step(runs, reference,
                                                       weights, job):
    got = _job_result(runs, job)
    p_ref, m_ref, mom_ref = reference[(job.arch, job.masked, job.grad_accum)]
    m = got["metrics"][0]
    np.testing.assert_allclose(m["loss"], float(m_ref["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], float(m_ref["grad_norm"]),
                               rtol=1e-5)
    assert m["grad_norm"] > 1.0                          # the clip is active
    p_port, p_old = _port_tree(job, got["params"]), _flat(weights[job.arch])
    assert sorted(p_port) == sorted(p_ref)
    # 1-D leaves of a stacked segment: the reference decays them (ndim >= 2
    # stacked), the port's 1-D parameters are not decayed (ROADMAP queue C)
    dims = _flat(convert.to_reference(
        LM(job.cfg(), device="cpu"),
        leaf=lambda p: torch.tensor(float(p.dim()))))
    for k in p_ref:
        want = p_ref[k]
        if p_ref[k].ndim >= 2 and np.all(dims[k] == 1):
            want = want + LR * WD * p_old[k]
        # |g| > 1e-6: the first moment is a tenth of the clipped gradient
        sure = np.abs(mom_ref[k]) > 1e-7 / float(m_ref["grad_norm"])
        np.testing.assert_allclose(p_port[k][sure], want[sure], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        assert np.all(np.abs(p_port[k] - want) <= 2 * LR + 1e-6), k


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_matches_dp_on_the_same_ranks(runs, arch):
    dp = _job_result(runs, Job(arch=arch, zero=0, lr=LR))
    for zero in (1, 3):
        z = _job_result(runs, Job(arch=arch, zero=zero, lr=LR))
        assert z["metrics"][0]["loss"] == dp["metrics"][0]["loss"]
        assert rehearse._rel(z["params"], dp["params"], 2 * LR) <= 1e-5


def test_collectives_of_each_rung(runs):
    """DP all-reduces every gradient; ZeRO-1 reduce-scatters the sharded
    ones and all-gathers their parameters after the update; ZeRO-3 gathers
    each sharded parameter twice (the forward and the remat recompute) and
    reduce-scatters its gradient once."""
    job = Job(arch="qwen2-0.5b", lr=LR)
    model = LM(job.cfg(), device="meta")
    n_params = len(list(model.parameters()))
    sharded = sum(1 for s in pol.param_specs(
        model, job.cfg(), PolicyConfig(zero_stage=3), {"data": 4}).values()
        if s)
    assert 0 < sharded < n_params
    t0 = _job_result(runs, dataclasses.replace(job, zero=0))["traffic"]
    t1 = _job_result(runs, dataclasses.replace(job, zero=1))["traffic"]
    t3 = _job_result(runs, dataclasses.replace(job, zero=3))["traffic"]
    # + the token count, the metrics and (ZeRO) the norm's partial sum
    assert t0["data/all_reduce"]["calls"] == n_params + 2
    assert "data/all_gather" not in t0 and "data/reduce_scatter" not in t0
    assert t1["data/reduce_scatter"]["calls"] == sharded
    assert t1["data/all_gather"]["calls"] == sharded
    assert t1["data/all_reduce"]["calls"] == n_params - sharded + 3
    assert t3["data/all_gather"]["calls"] == 2 * sharded
    assert t3["data/reduce_scatter"]["calls"] == sharded
    assert t3["data/all_gather"]["payload_bytes"] == \
        2 * t3["data/reduce_scatter"]["payload_bytes"]
    for t in (t0, t1, t3):
        assert all(r["ranks"] == 4 for r in t.values())


def _ref_encode(y, m):
    q, scale = ref_compress.int8_encode(jnp.asarray(y),
                                        lambda _: jnp.float32(m))
    return np.asarray(q), np.asarray(scale)


def _ref_decode(q, scale):
    return np.asarray(ref_compress.int8_decode(jnp.asarray(q),
                                               jnp.asarray(scale)))


def test_int8_exchange_matches_the_reference_functions(runs):
    ranks = [r["int8"] for r in runs[0]]
    assert sorted(tuple(r["coord"]) for r in ranks) == [(0, 0), (0, 1),
                                                       (1, 0), (1, 1)]
    want = rehearse.emulate_int8(ranks, _ref_encode, _ref_decode)
    for r, w in zip(ranks, want):
        for s, (got, ws) in enumerate(zip(r["steps"], w["steps"])):
            for part in ("out", "res"):
                for k in ws[part]:
                    np.testing.assert_allclose(
                        got[part][k], ws[part][k], rtol=1e-6,
                        atol=1e-6 * np.abs(ws[part][k]).max(),
                        err_msg=f"step {s} {part} {k}")
    # the residual carries: the second step's inputs include it
    assert any(np.abs(w["steps"][0]["res"]["a"]).max() > 0 for w in want)


def test_int8_exchange_moves_int8_and_agrees_on_one_scale(runs):
    t = runs[0][0]["int8"]["traffic"]
    n_leaves, n_steps = 3, 2
    elems = 37 * 53 + 1000 + 4 * 8 * 16
    assert t["pod/all_gather"]["calls"] == n_leaves * n_steps
    # one byte an element from each of the two pods
    assert t["pod/all_gather"]["payload_bytes"] == 2 * elems * n_steps
    # the only all-reduce is the fp32 scale's MAX: 4 bytes a leaf
    assert t["pod/all_reduce"] == {"calls": n_leaves * n_steps,
                                   "payload_bytes": 4 * n_leaves * n_steps,
                                   "ranks": 2,
                                   "wire_bytes_per_rank": 4.0 * 3 * 2}


@pytest.fixture(scope="module")
def pod_grads(weights):
    """The reference's gradient of each pod's mean loss for the int8 job's
    first step (its batch split over the pod axis first: pod 0 takes the
    first half of the rows), as flat reference leaves."""
    job = JOBS[-1]
    loss_fn = ref_trainer.make_loss_fn(
        ref_reduced(ref_get_config(job.arch)),
        RefPolicy(compute_dtype="float32", remat="block", attn_impl="xla"))
    grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))
    jp = jax.tree.map(jnp.asarray, weights[job.arch])
    batch, half = job.batch_at(0), job.batch // 2
    return [_flat(grad(jp, {k: jnp.asarray(v[i * half:(i + 1) * half])
                            for k, v in batch.items()})) for i in (0, 1)]


def test_int8_pod_exchange_in_the_step(pod_grads, runs, weights):
    """ZeRO-1 on (pod, data) = (2, 2) with int8_ef, held to the reference's
    exchange emulated on the host: each pod's mean gradient from
    ``jax.grad`` of the reference's loss on the pod's rows, one scale a
    reference leaf (a scanned segment's layers share it) over both pods,
    ``int8_encode`` / ``int8_decode``, the int32 sum over 2.  The step's
    exchanged gradient is read back from Adam's first moment (m = (1 - b1)
    x the clipped gradient after one step).  It must lie on the emulated
    grid and take the emulated value but where a pod's float32 gradient
    sits at a rounding edge (one step of the grid then); the grad norm, the
    residuals and the updated parameters follow.  The loss is the DP
    step's (it is computed before the exchange), and the pods exchange
    int8."""
    job = JOBS[-1]
    opt = AdamWConfig(lr=LR)
    got = _job_result(runs, job)
    dp = _job_result(runs, Job(arch="qwen2-0.5b", zero=0, lr=LR))
    np.testing.assert_allclose(got["metrics"][0]["loss"],
                               dp["metrics"][0]["loss"], rtol=1e-6)
    ranks = [{"coord": (i, 0), "steps": [{"g": g}]}
             for i, g in enumerate(pod_grads)]
    want = [w["steps"][0] for w in rehearse.emulate_int8(
        ranks, _ref_encode, _ref_decode)]
    out = want[0]["out"]
    norm = float(np.sqrt(sum(np.sum(np.square(v.astype(np.float64)))
                             for v in out.values())))
    m = got["metrics"][0]
    np.testing.assert_allclose(m["grad_norm"], norm, rtol=1e-6)
    # int8 rounding of each pod's gradient, against the unquantised DP's
    np.testing.assert_allclose(dp["metrics"][0]["grad_norm"], norm,
                               rtol=1 / 127)
    clip = min(1.0, opt.grad_clip / m["grad_norm"])
    exchanged = _port_tree(job, {n: v / (1 - opt.b1) / clip
                                 for n, v in got["m"].items()})
    res = [_port_tree(job, {n: v[i] for n, v in got["ef"].items()})
           for i in (0, 1)]
    p_port, p_old = _port_tree(job, got["params"]), _flat(weights[job.arch])
    dims = _flat(convert.to_reference(
        LM(job.cfg(), device="cpu"),
        leaf=lambda p: torch.tensor(float(p.dim()))))
    assert sorted(exchanged) == sorted(out)
    flips = total = 0
    for k, w in out.items():
        scale = float(_ref_encode(np.zeros(1, np.float32), max(
            float(np.abs(g[k]).max()) for g in pod_grads))[1])
        step = scale / 2                        # the mean of two pods
        k_got, k_want = exchanged[k] / step, w / step
        np.testing.assert_allclose(k_got, np.round(k_got), atol=1e-3,
                                   err_msg=f"{k}: off the emulated grid")
        d = np.round(k_got) - np.round(k_want)
        assert np.all(np.abs(d) <= 1), k
        flips += int(np.count_nonzero(d))
        total += d.size
        # the residual is y - q·scale: the gradient's float32 difference,
        # or that and one step where the pod's q flipped
        tol = 1e-5 * 127 * scale                # 1e-5 of the leaf's max
        for i in (0, 1):
            e = np.abs(res[i][k] - want[i]["res"][k])
            assert np.all((e <= tol) | (np.abs(e - scale) <= tol)), k
        # where the gradient clears a step of the grid its sign is sure:
        # Adam's first step moves by lr (g / |g|) plus the decay
        sure = np.abs(k_want) >= 2
        gc = w * min(1.0, opt.grad_clip / norm)
        upd = gc / (np.abs(gc) + opt.eps) + (
            opt.weight_decay * p_old[k] if np.all(dims[k] >= 2) else 0.0)
        np.testing.assert_allclose(p_port[k][sure],
                                   (p_old[k] - LR * upd)[sure], atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    assert flips <= 1e-4 * total, (flips, total)
    t = got["traffic"]
    n_params = len(dp["params"])
    assert t["pod/all_gather"]["calls"] == n_params
    # one agreed scale a reference leaf, over every rank
    assert t["pod+data/all_reduce"]["calls"] == len(out) < n_params
    assert "data/reduce_scatter" in t


def test_resume_from_four_ranks_onto_two_continues_the_run(runs):
    four, two, saved = runs
    first = four[0]["saved"]
    assert dict(first["system"].shape) == {"data": 2}
    assert two["step"] == SAVE_AT
    for k, v in saved.items():
        np.testing.assert_array_equal(two["restored"][k], v, err_msg=k)
    params = lambda d: {k: v for k, v in d.items()  # noqa: E731
                        if k.startswith("params/")}
    assert rehearse._rel(params(two["whole"]), params(first["whole"]),
                         2 * LR * SAVE_JOB.steps) <= 1e-5
    np.testing.assert_allclose(
        [m["loss"] for m in two["metrics"]],
        [m["loss"] for m in first["metrics"][SAVE_AT:]], rtol=1e-5)
    kinds = [e["kind"] for e in first["events"] + two["events"]]
    assert kinds == ["failure", "recompose", "restore"]


def test_meshes_need_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh((1,), ("data",), device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_production_mesh(multi_pod=True)
    s = compose.preset("localGPUs", data=2, model=2)
    with pytest.raises(RuntimeError, match="initialised process group"):
        s.mesh(device="cpu")


def test_launcher_trains_a_rung_on_a_one_rank_group(capsys, tmp_path):
    """``launch/train --mesh data=1 --rung``: a one-rank ``gloo`` group the
    program starts and ends itself, the rung's ZeRO stage, a checkpoint
    written and resumed under the mesh."""
    from repro_torch.launch import train as launch_train
    args = ["--device", "cpu", "--reduced", "--batch", "2", "--seq", "32",
            "--mesh", "data=1", "--rung", "DDP+mixed+sharded",
            "--ckpt", str(tmp_path / "ck"), "--log-every", "1"]
    assert launch_train.main(args + ["--steps", "2", "--fail-at", "1"]) == 17
    assert launch_train.main(args + ["--steps", "2", "--resume",
                                     "auto"]) == 0
    out = capsys.readouterr().out
    assert "zero 3, bfloat16 compute" in out and "resumed from step 1" in out
    assert "data/all_gather" in out and "data/reduce_scatter" in out
    assert not torch.distributed.is_initialized()


def test_moe_bert_and_vision_refuse_a_mesh():
    """MoE takes the sorted path in the global batch's order on a mesh
    without the tp axis (a one-rank ``data`` mesh's step is the no-mesh
    step; four ranks against the reference:
    ``tests/test_torch_tp_hybrid.py``) and expert parallelism on one with
    it (``tests/test_torch_tensor_parallel.py``); BERT and the vision
    models refuse any mesh."""
    from repro_torch.launch.mesh import one_rank
    mesh = object()
    job = Job(arch="moonshot-v1-16b-a3b")
    cfg, batch = job.cfg(), job.batch_at(0)
    policy = PolicyConfig(compute_dtype="float32")
    plain = trainer.init_state(cfg, policy, seed=0, device="cpu")
    _, want = trainer.make_train_step(cfg, policy)(plain, batch)
    with one_rank((1,), ("data",), device="cpu") as data_only:
        assert trainer.moe_impl(cfg, policy, data_only) == "sorted"
        state = trainer.init_state(cfg, policy, seed=0, device="cpu",
                                   mesh=data_only)
        _, got = trainer.make_train_step(cfg, policy, mesh=data_only)(
            state, batch)
    for key in ("loss", "aux", "grad_norm"):
        assert float(got[key]) == float(want[key]), key
    for n, p in plain.model.named_parameters():
        assert torch.equal(dict(state.model.named_parameters())[n], p), n
    with pytest.raises(NotImplementedError, match="BERT under a mesh"):
        trainer.paper_loss_fn(get_config("bert-base"), PolicyConfig(),
                              mesh=mesh)
    with pytest.raises(NotImplementedError, match="batch norm"):
        trainer.paper_loss_fn(RESNET50, PolicyConfig(), mesh=mesh)
