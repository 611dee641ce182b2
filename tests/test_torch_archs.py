"""Per-architecture smoke tests of the port, the sibling of
``tests/test_archs.py``: every assigned arch at its reduced size, one
forward and one train step on the CPU (shapes, finite values, parameters
moved); and the two MoE archs built whole on the meta device, their
parameter counts against ``jax.eval_shape`` of the reference's ``init_lm``.
The values themselves are held against the reference elsewhere
(``tests/test_torch_models.py``, ``test_torch_train.py``,
``test_torch_moe.py``, the recurrent archs' files).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm

from repro_torch.configs import ASSIGNED_ARCHS, get_config, reduced
from repro_torch.configs.base import PolicyConfig, ShapeConfig
from repro_torch.data import make_batch
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig
from repro_torch.train import trainer
from repro_torch.train.trainer import make_run_ctx

SMOKE_SHAPE = ShapeConfig("smoke", 64, 2, "train")
POLICY = PolicyConfig(compute_dtype="float32", remat="none",
                      attn_impl="kernel", zero_stage=0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port on one CPU thread: these models are small, and beside the
    other test workers' threads PyTorch's parallel regions stalled each
    test 10-30 times over (as in ``tests/test_torch_vision.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_forward_shapes_and_finite(arch):
    cfg = reduced(get_config(arch))
    model = LM.init(cfg, seed=0, device="cpu")
    batch = make_batch(cfg, SMOKE_SHAPE)
    with torch.no_grad():
        logits, _, aux = model(torch.from_numpy(batch["inputs"]),
                               make_run_ctx(cfg, POLICY))
    B, S = batch["labels"].shape
    assert logits.shape == (B, S, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_one_train_step(arch):
    cfg = reduced(get_config(arch))
    state = trainer.init_state(cfg, POLICY, AdamWConfig(lr=1e-3), seed=0,
                               device="cpu")
    before = {n: p.detach().clone() for n, p in state.params().items()}
    state, m = trainer.make_train_step(cfg, POLICY, AdamWConfig(lr=1e-3))(
        state, make_batch(cfg, SMOKE_SHAPE))
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    moved = [n for n, p in state.params().items()
             if not torch.equal(p, before[n])]
    assert moved
    if cfg.moe is not None:
        assert any(n.endswith("moe.router") for n in moved)
        assert any(n.endswith("moe.wi") for n in moved)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_full_size_moe_archs_build_with_the_reference_count(arch):
    """Built whole (48 layers) on the meta device in bf16: as many
    parameters as the reference's tree, the router fp32."""
    cfg = get_config(arch)
    model = LM(cfg, dtype=torch.bfloat16, device="meta")
    got = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(lambda k: ref_lm.init_lm(k, ref_get_config(arch)),
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert got == want
    moe = model.stack.blocks[-1].moe
    assert moe.router.dtype == torch.float32
    assert moe.wi.dtype == torch.bfloat16
    assert moe.wi.shape == (cfg.moe.n_experts, cfg.d_model,
                            cfg.moe.d_ff_expert)
