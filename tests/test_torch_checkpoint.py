"""The port's checkpoints: counterparts of ``tests/test_checkpoint.py``
(roundtrip, GC, a partial write is invisible, a shape mismatch raises, and
resuming is bit-exact), on the CPU with reduced ``qwen2-0.5b``."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import PolicyConfig, ShapeConfig
from repro_torch.data import make_batch
from repro_torch.optim import AdamWConfig
from repro_torch.train import checkpoint, trainer

SHAPE = ShapeConfig("t", 32, 2, "train")


def _tiny_state(param_dtype="float32", seed=0):
    cfg = reduced(get_config("qwen2-0.5b"))
    policy = PolicyConfig(compute_dtype="float32", param_dtype=param_dtype,
                          remat="none", attn_impl="kernel", zero_stage=0)
    return cfg, policy, trainer.init_state(cfg, policy, AdamWConfig(lr=1e-3),
                                           seed=seed, device="cpu")


def _stepped(param_dtype="float32"):
    """A state after one step: moments and (bf16) masters are non-zero."""
    cfg, policy, state = _tiny_state(param_dtype)
    step = trainer.make_train_step(cfg, policy, AdamWConfig(lr=1e-3))
    state, _ = step(state, make_batch(cfg, SHAPE))
    return cfg, policy, state, step


def _leaves(state):
    return checkpoint._leaves(state)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_save_restore_roundtrip(tmp_path, param_dtype):
    _, _, state, _ = _stepped(param_dtype)
    d = str(tmp_path / "ck")
    checkpoint.save(d, 7, state, extra={"note": "x"})
    _, _, fresh = _tiny_state(param_dtype, seed=1)     # other weights
    restored, step = checkpoint.restore(d, fresh)
    assert step == 7 and restored is fresh
    assert restored.opt.step == state.opt.step == 1
    a, b = _leaves(state), _leaves(restored)
    assert sorted(a) == sorted(b)
    assert any(k.startswith("opt/master/") for k in a) == \
        (param_dtype == "bfloat16")
    for k in a:
        if torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k], b[k]), k
    meta = checkpoint.meta(d, 7)
    assert meta["step"] == 7 and meta["extra"] == {"note": "x"}
    assert meta["keys"] == sorted(a)


def test_gc_keeps_latest_k(tmp_path):
    _, _, state = _tiny_state()
    d = str(tmp_path / "ck")
    for s in range(6):
        checkpoint.save(d, s, state, keep=3)
    assert checkpoint.all_steps(d) == [3, 4, 5]
    assert checkpoint.latest_step(d) == 5
    assert not [n for n in os.listdir(d) if n.startswith("tmp.")]


def test_partial_write_is_invisible(tmp_path):
    """A crashed writer (step dir without DONE, orphaned tmp dir) must not
    surface as a step, and the next save sweeps the orphan."""
    _, _, state = _tiny_state()
    d = str(tmp_path / "ck")
    checkpoint.save(d, 1, state)
    os.makedirs(os.path.join(d, "step_0000000002"))
    os.makedirs(os.path.join(d, "tmp.3.crashed"))
    assert checkpoint.all_steps(d) == [1]
    _, step = checkpoint.restore(d, state)
    assert step == 1
    checkpoint.save(d, 4, state)
    assert not os.path.exists(os.path.join(d, "tmp.3.crashed"))


def test_restore_shape_mismatch_raises(tmp_path):
    cfg, policy, state = _tiny_state()
    d = str(tmp_path / "ck")
    checkpoint.save(d, 1, state)
    bad = {"params": {n: torch.zeros((3,) + tuple(p.shape))
                      for n, p in state.model.named_parameters()}}
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(d, bad)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "empty"), state)


def test_training_resume_bit_exact(tmp_path):
    """save at t, continue to t+2 == restore at t into a fresh state,
    replay to t+2."""
    cfg, policy, state = _tiny_state()
    step_fn = trainer.make_train_step(cfg, policy, AdamWConfig(lr=1e-3))
    d = str(tmp_path / "ck")
    for i in range(2):
        state, _ = step_fn(state, make_batch(cfg, SHAPE, step=i))
    checkpoint.save(d, 2, state)
    for i in range(2, 4):
        state, _ = step_fn(state, make_batch(cfg, SHAPE, step=i))
    _, _, replay = _tiny_state(seed=3)
    replay, step = checkpoint.restore(d, replay)
    for i in range(step, 4):
        replay, _ = step_fn(replay, make_batch(cfg, SHAPE, step=i))
    assert replay.opt.step == state.opt.step == 4
    for a, b in zip(state.model.parameters(), replay.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6)


def test_checkpoint_files_follow_the_reference_layout(tmp_path):
    _, _, state = _tiny_state()
    d = str(tmp_path / "ck")
    path = checkpoint.save(d, 12, state)
    assert os.path.basename(path) == "step_0000000012"
    assert sorted(os.listdir(path)) == ["DONE", "arrays.npz", "meta.json"]
    with open(os.path.join(path, "meta.json")) as f:
        keys = json.load(f)["keys"]
    assert "opt/step" in keys and "params/embed" in keys
    assert "opt/m/embed" in keys and "opt/v/embed" in keys
