"""The recurrent serving slice as a whole: ``mamba2-780m`` (SSD mixers) and
``recurrentgemma-2b`` (RG-LRU blocks and sliding-window attention), reduced,
through the port's LM and engines against the reference's.

The same weights (the reference's init redrawn by numpy, converted by
``repro_torch.convert.from_reference``) and the same prompts go through both
packages on the CPU in fp32.  Greedy token streams must be **identical**;
logits agree within 2e-4 (fp32 on both sides, other summation orders, the
SSD scan inside); a pow2-padded prefill reproduces the exact-length one
within 1e-5.  recurrentgemma runs three layers, (R, R, A), so that its local
attention is on the path; its reduced window is 64 and the prompts are
longer than that, so windows mask and rings wrap.
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
from repro.models import lm as ref_lm
from repro.serve import AsyncServeEngine as RefAsyncServeEngine
from repro.serve import ServeRequest as RefServeRequest
from repro.train.trainer import make_run_ctx as ref_make_run_ctx

from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models.lm import LM
from repro_torch.serve import (AsyncServeEngine, Request, ServeEngine,
                               ServeRequest)
from repro_torch.serve.engine import make_prefill_step
from repro_torch.train import trainer
from repro_torch.train.trainer import make_run_ctx

ARCHS = {"mamba2-780m": 2, "recurrentgemma-2b": 3}      # arch -> layers
TOL = dict(atol=2e-4, rtol=2e-4)
REF_POLICY = RefPolicy(compute_dtype="float32", remat="none",
                       attn_impl="full")
POLICY = PolicyConfig(compute_dtype="float32", remat="none",
                      attn_impl="kernel")
ENGINE_KW = dict(n_slots=3, max_seq=96)


class FixedClock:
    """Injected clock: advances 1 ms per reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _prompt(seed, n, vocab):
    return [int(t) for t in np.random.RandomState(seed).randint(0, vocab, n)]


@pytest.fixture(scope="module", params=list(ARCHS))
def weights(request):
    arch = request.param
    ref_cfg = ref_reduced(ref_get_config(arch), n_layers=ARCHS[arch])
    tree = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    r = np.random.RandomState(0)

    def redraw(a):
        a = np.asarray(a)
        std = float(a.std()) or 0.1
        return (float(a.mean())
                + r.standard_normal(a.shape) * std).astype(np.float32)

    params = jax.tree.map(redraw, tree)
    return ref_cfg, params, reduced(get_config(arch), n_layers=ARCHS[arch])


def _model(weights):
    return convert.from_reference(weights[1], weights[2], device="cpu")


def _prompts(cfg):
    # one pow2 bucket (capped at max_seq 96), all longer than the window 64
    return [_prompt(10 + i, 66 + 4 * i, cfg.vocab_size) for i in range(3)]


def _serve(eng, prompts, cls, max_new=4):
    reqs = [cls(i, list(p), max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    return reqs


# ---------------------------------------------------------------------------
# the LM forward
# ---------------------------------------------------------------------------
def test_lm_logits_match_reference(weights):
    ref_cfg, params, cfg = weights
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)
    want, _, _ = ref_lm.forward(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(toks), ref_cfg,
                                ref_make_run_ctx(ref_cfg, REF_POLICY, None))
    before = dict(ops.launch_counts())
    with torch.no_grad():
        got, _, _ = _model(weights)(torch.from_numpy(toks),
                                    make_run_ctx(cfg, POLICY))
    assert ops.launch_counts() == before        # CPU: no kernel launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
def test_greedy_streams_identical_to_reference(weights):
    ref_cfg, params, cfg = weights
    prompts = _prompts(cfg)
    ref_eng = RefAsyncServeEngine(ref_cfg, jax.tree.map(jnp.asarray, params),
                                  REF_POLICY, clock=FixedClock(),
                                  **ENGINE_KW)
    ref = _serve(ref_eng, prompts, RefServeRequest)
    before = dict(ops.launch_counts())
    eng = AsyncServeEngine(cfg, _model(weights), POLICY, clock=FixedClock(),
                           device="cpu", **ENGINE_KW)
    assert eng.mode == ref_eng.mode == "dense"
    got = _serve(eng, prompts, ServeRequest)
    assert [r.out for r in got] == [r.out for r in ref]
    assert ops.launch_counts() == before
    assert eng.report()["requests"]["completed"] == len(prompts)


def test_dense_engine_serves_below_the_window():
    """max_seq 48 < window 64: the reference's dense engine cannot scatter
    its 64-slot prefill ring into a 48-slot slot ring (ROADMAP queue C); the
    port's prefill makes min(window, capacity) slots and serves, with the
    streams of a roomy engine (no position reaches the window)."""
    ref_cfg = ref_reduced(ref_get_config("recurrentgemma-2b"), n_layers=3)
    cfg = reduced(get_config("recurrentgemma-2b"), n_layers=3)
    params = jax.tree.map(np.array,
                          ref_lm.init_lm(jax.random.PRNGKey(1), ref_cfg))
    prompts = [_prompt(40 + i, 30 + 5 * i, cfg.vocab_size) for i in range(2)]
    ref_eng = RefAsyncServeEngine(ref_cfg, jax.tree.map(jnp.asarray, params),
                                  REF_POLICY, n_slots=2, max_seq=48)
    assert ref_eng.submit(RefServeRequest(0, prompts[0], max_new=4))
    with pytest.raises(ValueError, match="broadcast"):
        ref_eng.run()
    model = convert.from_reference(params, cfg, device="cpu")
    outs = []
    for max_seq in (48, 96):
        eng = AsyncServeEngine(cfg, model, POLICY, n_slots=2,
                               max_seq=max_seq, device="cpu")
        outs.append([r.out for r in _serve(eng, prompts, ServeRequest)])
        assert eng.caches[2]["k"].shape[1] == min(64, max_seq)
    assert outs[0] == outs[1]


def test_dense_slots_equal_teacher_forcing(weights):
    """ServeEngine's slots (one-shot prefill, then decode steps over conv
    tails, recurrent states and ring buffers) generate what greedy argmax
    over the full forward of prompt + generated tokens gives."""
    _, _, cfg = weights
    model = _model(weights)
    ctx = make_run_ctx(cfg, POLICY)
    eng = ServeEngine(cfg, model, POLICY, n_slots=2, max_seq=96,
                      device="cpu")
    reqs = [Request(i, torch.tensor(_prompt(30 + i, 60 + 7 * i,
                                            cfg.vocab_size)), max_new=6)
            for i in range(2)]
    for r in reqs:
        assert eng.add_request(r)
    while not all(r.done for r in reqs):
        eng.step()
    for r in reqs:
        seq = torch.cat([r.prompt, torch.tensor(r.out[:-1])])[None]
        with torch.no_grad():
            logits, _, _ = model(seq.to(torch.int32), ctx)
        want = logits[0, len(r.prompt) - 1:].argmax(-1).tolist()
        assert r.out == want


def test_bucketed_prefill_exact_for_recurrent_archs(weights):
    """Padded columns must not leak into recurrent, conv or ring state: the
    pow2-padded prefill reproduces the exact-length prefill -- logits,
    recurrent states, conv tails, and the live ring slots."""
    _, _, cfg = weights
    model = _model(weights)
    exact = make_prefill_step(cfg, POLICY, cache_capacity=32)
    bucket = make_prefill_step(cfg, POLICY, cache_capacity=32, bucketed=True)
    L = 21
    toks = _prompt(3, L, cfg.vocab_size)
    lo, c1 = exact(model, torch.tensor([toks], dtype=torch.int32))
    lb, c2 = bucket(model, torch.tensor([toks + [0] * (32 - L)],
                                        dtype=torch.int32),
                    torch.tensor([L], dtype=torch.int32))
    np.testing.assert_allclose(lo.numpy(), lb.numpy(), atol=1e-5)
    for a, b in zip(c1, c2):
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name].shape == b[name].shape, name
            if name == "pos":
                np.testing.assert_array_equal(a[name].numpy(),
                                              b[name].numpy())
            elif name in ("k", "v"):
                live = b["pos"].numpy() >= 0
                np.testing.assert_allclose(a[name].numpy()[live],
                                           b[name].numpy()[live], atol=1e-5)
            else:      # recurrent state / conv tails: exact everywhere
                np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                           atol=1e-5)


def test_engines_default_to_cuda_and_training_raises(weights):
    _, _, cfg = weights
    model = _model(weights)
    if not torch.cuda.is_available():
        for cls in (AsyncServeEngine, ServeEngine):
            with pytest.raises(RuntimeError, match="CUDA"):
                cls(cfg, model, POLICY)
    # both archs train (SSDFn, RGLRUFn); like the engines, the trainer's
    # state is made on the card unless the caller names the CPU
    assert callable(trainer.make_train_step(cfg, POLICY))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            trainer.init_state(cfg, POLICY)


def test_launch_serve_runs_the_recurrent_archs_on_cpu(weights, capsys):
    arch = weights[2].name.replace("-reduced", "")
    rc = launch_serve.main(["--device", "cpu", "--arch", arch,
                            "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert rc == 0 and "served 3/3" in out and "dense mode" in out


# ---------------------------------------------------------------------------
# on the card (skipped where there is none)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card "
                    "(python3 chip_smoke.py holds them against their plain "
                    "versions there)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_recurrent_lm_kernels_match_plain_on_the_card(weights, cuda_device):
    """The LM forward through the SSD / RG-LRU / windowed flash kernels
    against the same forward through their plain versions, and the kernels
    launched once per layer that holds one."""
    _, params, cfg = weights
    model = convert.from_reference(params, cfg, device=cuda_device)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 100)).astype(np.int32)).to(cuda_device)
    plain = dataclasses.replace(POLICY, attn_impl="full")
    ops.reset_launch_counts()
    with torch.no_grad():
        got, _, _ = model(toks, make_run_ctx(cfg, POLICY))
        counts = ops.launch_counts()
        want, _, _ = model(toks, make_run_ctx(cfg, plain))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    pat = cfg.pattern
    assert counts["ssd"] == pat.count("ssm")
    assert counts["rglru"] == pat.count("rglru")
    assert counts["flash_attention"] == pat.count("attn_local")
