"""Port vs reference: BERT with the SQuAD QA head (``repro_torch.models.bert``
against ``repro/models/bert.py``), at the reference test's reduced BERT
(``tests/test_paper_bench.py``: 2 layers, d_model 64, 4 heads, vocab 512,
S = 32), on the CPU in fp32.

The same numpy weights (the reference's init with every leaf redrawn, so
biases and norm scales move off 0 and 1) and the same numpy batch go through
``forward_qa`` / ``qa_loss`` on both sides.  Tolerances: logits 2e-5 of
their max-abs (fp32 forward through two layers); the loss and every
gradient 5e-4 of the leaf's max-abs (the backward tolerance of
``tests/test_kernels_bwd.py``).  On CPU tensors ``attn_impl="kernel"`` runs
the attention Function's plain versions, so it exercises the path the card
runs through the B2 kernels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_bench as ref_pb
from repro.models import bert as ref_bert
from repro.models.transformer import RunCtx as RefCtx

from repro_torch import convert
from repro_torch.configs import paper_bench as pb
from repro_torch.configs.base import PolicyConfig
from repro_torch.models import bert
from repro_torch.models.transformer import RunCtx
from repro_torch.optim import AdamWConfig
from repro_torch.train import trainer

SMALL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
             vocab_size=512, block_pattern=("attn",) * 2, max_seq=64)
REF_CFG = dataclasses.replace(ref_pb.BERT_BASE, **SMALL)
CFG = dataclasses.replace(pb.BERT_BASE, **SMALL)
B, S = 2, 32
# leaves whose gradient is zero in exact arithmetic: a constant added to
# every position's span logit (final_norm.bias and qa_head.b through the
# head) or to every key's score (bk) leaves the softmax unchanged
ZERO_GRAD = ("final_norm.bias", "qa_head.b", "attn.bk")


@pytest.fixture(scope="module")
def params():
    tree = ref_bert.init_bert_qa(jax.random.PRNGKey(0), REF_CFG)
    r = np.random.RandomState(0)

    def redraw(a):
        a = np.asarray(a)
        std = float(a.std()) or 0.1
        return (float(a.mean())
                + r.standard_normal(a.shape) * std).astype(np.float32)

    return jax.tree.map(redraw, tree)


def _batch(segments=True, mask=False):
    r = np.random.RandomState(1)
    out = {"tokens": r.randint(0, CFG.vocab_size, (B, S)).astype(np.int32),
           "start": np.array([3, 7], np.int32),
           "end": np.array([5, 20], np.int32)}
    if segments:
        out["segments"] = (np.arange(S)[None, :]
                           >= np.array([[10], [14]])).astype(np.int32)
    if mask:
        out["mask"] = np.arange(S)[None, :] < np.array([[S], [24]])
    return out


def _ref(params, batch, impl="full"):
    ctx = RefCtx(compute_dtype=jnp.float32, attn_impl=impl, remat="none")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits = ref_bert.forward_qa(
        jax.tree.map(jnp.asarray, params), jb["tokens"], REF_CFG, ctx,
        segments=jb.get("segments"), attn_mask=jb.get("mask"))
    return [np.asarray(x) for x in logits]


def _port(params, impl="kernel"):
    model = convert.bert_from_reference(params, CFG, device="cpu")
    return model, RunCtx(compute_dtype=torch.float32, attn_impl=impl,
                         remat="none")


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("impl", ["full", "kernel"])
@pytest.mark.parametrize("segments", [False, True])
def test_forward_qa_matches_reference(params, impl, segments):
    batch = _batch(segments)
    want = _ref(params, batch)
    model, ctx = _port(params, impl)
    tb = _tb(batch)
    with torch.no_grad():
        got = bert.forward_qa(model, tb["tokens"], ctx,
                              segments=tb.get("segments"))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (B, S)
        _close(g.numpy(), w, 2e-5)


@pytest.mark.parametrize("impl,segments", [("kernel", False),
                                           ("kernel", True),
                                           ("full", True)])
def test_qa_loss_and_gradients_match_jax_grad(params, impl, segments):
    batch = _batch(segments)
    ctx = RefCtx(compute_dtype=jnp.float32, attn_impl="full", remat="none")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (want_loss, _), want = jax.value_and_grad(
        lambda p: ref_bert.qa_loss(p, jb, REF_CFG, ctx), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model, pctx = _port(params, impl)
    loss, metrics = bert.qa_loss(model, _tb(batch), pctx)
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - float(want_loss)) <= 5e-4 * abs(float(want_loss))
    assert float(metrics["loss"].detach()) == loss
    got = convert.flatten_tree(convert.bert_to_reference(
        model, lambda p: torch.zeros_like(p) if p.grad is None else p.grad))
    want = convert.flatten_tree(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        if not segments and name == "segment_embed":
            assert not np.any(w) and not np.any(got[name])
        elif name.endswith(ZERO_GRAD):
            # the loss does not move with these leaves: both sides' gradients
            # are rounding, held to the largest gradient instead
            assert np.abs(w).max() <= 1e-6 * scale
            assert np.abs(got[name]).max() <= 1e-6 * scale
        else:
            _close(got[name], w, 5e-4)


def test_masked_batch_on_full_matches_the_reference_full(params):
    batch = _batch(mask=True)
    want = _ref(params, batch, "full")
    unmasked = _ref(params, _batch(), "full")
    # the mask matters: the padded row's logits move without it
    assert np.abs(want[0][1] - unmasked[0][1]).max() > 1e-3
    model, ctx = _port(params, "full")
    tb = _tb(batch)
    with torch.no_grad():
        got = bert.forward_qa(model, tb["tokens"], ctx,
                              segments=tb["segments"], attn_mask=tb["mask"])
        loss, _ = bert.qa_loss(model, tb, ctx)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 2e-5)
    ref_loss, _ = ref_bert.qa_loss(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()}, REF_CFG,
        RefCtx(compute_dtype=jnp.float32, attn_impl="full", remat="none"))
    assert abs(float(loss) - float(ref_loss)) <= 2e-5 * abs(float(ref_loss))


def test_kernel_path_with_a_mask_raises(params):
    """The flash kernels take no key mask: a padded batch must not silently
    attend to its padding on ``attn_impl="kernel"``."""
    model, ctx = _port(params, "kernel")
    with pytest.raises(NotImplementedError, match="attn_impl='full'"):
        bert.qa_loss(model, _tb(_batch(mask=True)), ctx)


def test_reference_flash_path_drops_the_padding_mask(params):
    """A fault of the reference (ROADMAP queue C): its default ``"xla"``
    flash path ignores ``attn_mask``, so a padded batch attends to its
    padding there; ``"full"`` masks it."""
    masked, plain = _batch(mask=True), _batch()
    xla = [_ref(params, b, "xla") for b in (masked, plain)]
    full = [_ref(params, b, "full") for b in (masked, plain)]
    for a, b in zip(*xla):
        np.testing.assert_array_equal(a, b)
    assert np.abs(full[0][1][1] - full[1][1][1]).max() > 1e-3


def test_converter_round_trips_every_leaf(params):
    model = convert.bert_from_reference(params, CFG, device="cpu")
    back = convert.flatten_tree(convert.bert_to_reference(model))
    want = convert.flatten_tree(params)
    assert set(back) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(back[name], w)
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(w).size for w in want.values())


@pytest.mark.parametrize("name", ["bert-base", "bert-large"])
def test_full_size_parameter_count_equals_the_reference(name):
    """Built on the meta device (shapes only) against ``jax.eval_shape`` of
    the reference's init, and within 3 % of Table II (110 M / 340 M)."""
    cfg = {"bert-base": pb.BERT_BASE, "bert-large": pb.BERT_LARGE}[name]
    ref_cfg = {"bert-base": ref_pb.BERT_BASE,
               "bert-large": ref_pb.BERT_LARGE}[name]
    shapes = jax.eval_shape(lambda k: ref_bert.init_bert_qa(k, ref_cfg),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    got = sum(p.numel() for p in bert.BertQA(cfg, device="meta").parameters())
    assert got == want
    paper = {"bert-base": 110e6, "bert-large": 340e6}[name]
    assert abs(got - paper) / paper < 0.03


def test_init_runs_on_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert.BertQA.init(CFG)
    model = bert.BertQA.init(CFG, device="cpu")
    assert model.device.type == "cpu"


def test_train_step_with_remat_matches_without_and_the_loss_falls(params):
    """``trainer.make_step`` over ``paper_loss_fn``: the card's ``paper_bench``
    step (per-block remat, the kernel path) at the reduced size in fp32.
    One step's gradients equal those without remat (the recompute is the
    same arithmetic), and three steps on one batch lower the loss."""
    opt = AdamWConfig(lr=1e-3)
    runs = {}
    for remat in ("block", "none"):
        policy = PolicyConfig(compute_dtype="float32", param_dtype="float32",
                              remat=remat, attn_impl="kernel")
        state = trainer.TrainState.create(
            convert.bert_from_reference(params, CFG, device="cpu"), policy,
            opt)
        step = trainer.make_step(trainer.paper_loss_fn(CFG, policy), opt)
        losses = [float(step(state, _batch())[1]["loss"]) for _ in range(3)]
        runs[remat] = (losses, state.model)
    assert runs["block"][0][-1] < runs["block"][0][0], runs["block"][0]
    assert runs["block"][0] == runs["none"][0]
    for (n, a), b in zip(runs["block"][1].named_parameters(),
                         runs["none"][1].parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
