"""Port vs reference: configs, leaf layers, registry helpers, import hygiene.

The same numpy inputs (made from a seed) go through the JAX function and its
``repro_torch`` counterpart, everything on the CPU in fp32.  Tolerance
``atol = rtol = 1e-5``: elementwise fp32 math whose only difference is the
order of the reductions inside norms and small matmuls.
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.kernels import registry as ref_registry
from repro.models import layers as ref_layers

import repro_torch.configs as configs
from repro_torch.kernels import registry
from repro_torch.models import layers

TOL = dict(atol=1e-5, rtol=1e-5)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _rng(seed=0):
    return np.random.RandomState(seed)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(ref_configs.REGISTRY))
def test_config_matches_reference(arch):
    a, b = configs.get_config(arch), ref_configs.get_config(arch)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(configs.reduced(a)) == \
        dataclasses.asdict(ref_configs.reduced(b))
    assert a.padded_vocab == b.padded_vocab
    assert a.param_count() == b.param_count()


def test_registry_lists_the_same_archs():
    assert sorted(configs.REGISTRY) == sorted(ref_configs.REGISTRY)
    assert configs.ASSIGNED_ARCHS == ref_configs.ASSIGNED_ARCHS
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_policy_attn_impl_names():
    assert configs.PolicyConfig().attn_impl == "kernel"


@pytest.mark.parametrize("n,floor", [(1, 1), (3, 1), (16, 16), (17, 16),
                                     (100, 32), (2048, 32)])
def test_bucket_pow2_matches_reference(n, floor):
    assert registry.bucket_pow2(n, floor) == ref_registry.bucket_pow2(n, floor)


@pytest.mark.parametrize("block,dim", [(256, 192), (64, 64), (512, 100),
                                       (7, 30), (1, 5)])
def test_fit_block_matches_reference(block, dim):
    assert registry.fit_block(block, dim) == ref_registry.fit_block(block, dim)


# ---------------------------------------------------------------------------
# leaf layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    r = _rng(1)
    x = r.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 0.5
    p = {"scale": 1 + 0.1 * r.standard_normal(48).astype(np.float32),
         "bias": 0.1 * r.standard_normal(48).astype(np.float32)}
    want = ref_layers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), kind, 1e-5)
    got = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_norm_module_keeps_input_dtype_and_computes_in_fp32():
    r = _rng(2)
    x = torch.from_numpy(r.standard_normal((3, 32)).astype(np.float32))
    norm = layers.Norm("rmsnorm", 32)
    with torch.no_grad():
        y, y32 = norm(x.bfloat16()), norm(x)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(), y32.numpy(),
                               atol=2e-2, rtol=2e-2)   # bf16 in/out rounding


@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_rope_matches_reference(fraction):
    r = _rng(3)
    x = r.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = r.randint(0, 500, (2, 9)).astype(np.int32)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 fraction=fraction, theta=500000.0)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            fraction=fraction, theta=500000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_preserves_norm_and_zero_fraction_is_identity():
    r = _rng(4)
    x = torch.from_numpy(r.standard_normal((1, 7, 2, 16)).astype(np.float32))
    pos = torch.arange(7, dtype=torch.int32)[None]
    y = layers.apply_rope(x, pos)
    np.testing.assert_allclose(y.norm(dim=-1).numpy(),
                               x.norm(dim=-1).numpy(), **TOL)
    assert layers.apply_rope(x, pos, fraction=0.0) is x


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    r = _rng(5)
    x = r.standard_normal((2, 6, 32)).astype(np.float32)
    p = {"wi": r.standard_normal((32, 80)).astype(np.float32) / 6,
         "wg": r.standard_normal((32, 80)).astype(np.float32) / 6,
         "wo": r.standard_normal((80, 32)).astype(np.float32) / 9}
    want = ref_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), act, jnp.float32)
    got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), act, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embed_and_unembed_match_reference():
    r = _rng(6)
    table = r.standard_normal((64, 16)).astype(np.float32)
    toks = r.randint(0, 64, (2, 5)).astype(np.int32)
    want = ref_layers.embed_tokens({"table": jnp.asarray(table)},
                                   jnp.asarray(toks), jnp.float32)
    got = layers.embed_tokens(torch.from_numpy(table),
                              torch.from_numpy(toks), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = r.standard_normal((2, 5, 16)).astype(np.float32)
    want = ref_layers.unembed(jnp.asarray(table), jnp.asarray(x), jnp.float32)
    got = layers.unembed(torch.from_numpy(table), torch.from_numpy(x),
                         torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sinusoidal_positions_match_reference():
    pos = np.arange(11, dtype=np.int32)[None]
    want = ref_layers.sinusoidal_positions(jnp.asarray(pos), 32)
    got = layers.sinusoidal_positions(torch.from_numpy(pos), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_helpers_take_a_generator():
    g = torch.Generator().manual_seed(0)
    w = layers.dense_init(g, (256, 64))
    assert w.shape == (256, 64) and w.dtype == torch.float32
    std = 1 / 16.0
    assert float(w.abs().max()) <= 2 * std + 1e-6       # truncated at 2 sigma
    assert 0.7 * std < float(w.std()) < std             # ~0.88 sigma
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(w, layers.dense_init(g2, (256, 64)))
    e = layers.embed_init(g, (128, 32), dtype=torch.bfloat16)
    assert e.dtype == torch.bfloat16 and 0.015 < float(e.float().std()) < 0.025


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------
def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    assert files and smoke.exists()
    return files + [smoke]


def test_port_imports_neither_jax_nor_the_reference_package():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert not bad, bad


def test_port_modules_import_without_nvcc_triton_or_jax():
    """Every module of the port imports in a fresh interpreter where
    ``jax``, ``repro`` and ``triton`` cannot be imported and ``nvcc`` is not
    on the PATH: building and loading kernels happens at first launch."""
    mods = []
    pkg = ROOT / "src" / "repro_torch"
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    assert "repro_torch.kernels.ops" in mods
    code = (
        "import sys, importlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro', "
        "'triton'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.kernels import ops\n"
        "assert ops.launch_counts() == {'flash_attention': 0, "
        "'paged_decode_attention': 0, 'flash_attention_fwd_stats': 0, "
        "'flash_attention_bwd_dkv': 0, 'flash_attention_bwd_dq': 0, "
        "'ssd': 0, 'ssd_bwd': 0, 'rglru': 0, 'rglru_bwd': 0}\n"
        "print('ok', len(sys.modules))\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/nonexistent",
           "HOME": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
