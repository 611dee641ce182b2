"""Carry the reference's weights across: ``from_reference`` turns the JAX
package's parameter pytree -- handed over **as nested dicts of numpy arrays**
(the caller does ``jax.tree.map(np.asarray, params)``; nothing here ever sees
a JAX array) -- into the port's ``LM``.

The reference stacks its layers per scanned segment
(``repro/models/transformer.py:190-205``): ``stack/seg{i}/slot{j}`` leaves
carry a leading layer axis when the segment's repeat count is > 1.  This
unstacks them into the ``ModuleList`` (layer order: for each repeat, for
each slot of the unit).  Weight layouts are the same on both sides
(``wq (d,H,hd)``, ``wk/wv (d,K,hd)``, ``wo (H,hd,d)``, ``wi/wg (d,ff)``,
``mlp.wo (ff,d)``, tables ``(padded_vocab, d)``; the ``ssm`` and ``rglru``
mixers' leaves under the reference's names; a block's ``moe`` subtree:
``router (d,E)``, ``wi/wg (E,d,f)``, ``wo (E,f,d)`` and the ``shared`` MLP),
so leaves are copied, not transposed.

``bert_from_reference`` / ``bert_to_reference`` carry ``init_bert_qa``'s
pytree (the ``LM`` leaves plus ``segment_embed`` and ``qa_head``), and
``vision_from_reference`` / ``vision_to_reference`` the three vision
models' (``repro/models/vision.py``): their parameter names mirror the
reference's nested dicts and lists leaf for leaf, and conv weights go from
the reference's HWIO to PyTorch's OIHW.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import RGLRU, SSM, ModelConfig
from repro_torch.configs.paper_bench import VisionConfig
from repro_torch.models import vision
from repro_torch.models.bert import BertQA
from repro_torch.models.lm import LM, require_device
from repro_torch.models.transformer import plan_segments


def _layer_trees(stack: Mapping[str, Any], cfg: ModelConfig):
    """The reference's per-layer parameter dicts, in layer order."""
    out = []
    for si, (unit, k) in enumerate(plan_segments(cfg.pattern)):
        seg = stack[f"seg{si}"]
        for rep in range(k):
            for slot in range(len(unit)):
                tree = seg[f"slot{slot}"]
                out.append(_take(tree, rep) if k > 1 else tree)
    if len(out) != cfg.n_layers:
        raise ValueError(f"reference stack has {len(out)} layers, config "
                         f"{cfg.name} has {cfg.n_layers}")
    return out


def _take(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _put(param: nn.Parameter, arr, name: str) -> None:
    a = np.asarray(arr)
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"{name}: reference leaf {a.shape} does not fit "
                         f"{tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.ascontiguousarray(a))
                    .to(param.dtype))


def _put_norm(norm, tree, name: str) -> None:
    _put(norm.scale, tree["scale"], f"{name}.scale")
    if norm.kind == "layernorm":
        _put(norm.bias, tree["bias"], f"{name}.bias")


def from_reference(params: Mapping[str, Any], cfg: ModelConfig, *,
                   dtype=torch.float32, device="cuda") -> LM:
    """Build the port's ``LM`` holding the reference's weights.

    ``params``: the pytree of ``repro.models.lm.init_lm`` as nested dicts of
    numpy arrays.  Handles ``tie_embeddings`` (no ``head`` leaf), ``qkv_bias``,
    ``qk_norm``, layernorm biases and the padded vocabulary (tables have
    ``cfg.padded_vocab`` rows on both sides)."""
    model = LM(cfg, dtype=dtype, device=require_device(device))
    _load_lm(model, params, cfg)
    return model


def _load_lm(model: LM, params: Mapping[str, Any], cfg: ModelConfig) -> None:
    _put(model.embed, params["embed"]["table"], "embed.table")
    if not cfg.tie_embeddings:
        _put(model.head, params["head"]["table"], "head.table")
    if cfg.pos_embedding == "learned":
        _put(model.pos_embed, params["pos_embed"], "pos_embed")
    _put_norm(model.final_norm, params["final_norm"], "final_norm")
    for i, (block, tree) in enumerate(
            zip(model.stack.blocks, _layer_trees(params["stack"], cfg))):
        pre = f"layer{i}"
        _put_norm(block.norm1, tree["norm1"], f"{pre}.norm1")
        if block.blk in (SSM, RGLRU):
            mixer = getattr(block, block.blk)
            t = tree[block.blk]
            for n, p in mixer.named_parameters(recurse=False):
                _put(p, t[n], f"{pre}.{block.blk}.{n}")
            if block.blk == SSM:
                _put_norm(mixer.norm, t["norm"], f"{pre}.ssm.norm")
        else:
            a = tree["attn"]
            for n in ("wq", "wk", "wv", "wo"):
                _put(getattr(block.attn, n), a[n], f"{pre}.attn.{n}")
            if cfg.qkv_bias:
                for n in ("bq", "bk", "bv"):
                    _put(getattr(block.attn, n), a[n], f"{pre}.attn.{n}")
            if cfg.qk_norm:
                _put_norm(block.attn.q_norm, a["q_norm"],
                          f"{pre}.attn.q_norm")
                _put_norm(block.attn.k_norm, a["k_norm"],
                          f"{pre}.attn.k_norm")
        if ("mlp" in tree or "moe" in tree) and not cfg.parallel_residual:
            _put_norm(block.norm2, tree["norm2"], f"{pre}.norm2")
        if "mlp" in tree:
            _put_mlp(block.mlp, tree["mlp"], f"{pre}.mlp")
        if "moe" in tree:
            t = tree["moe"]
            for n in ("router", "wi", "wg", "wo"):
                _put(getattr(block.moe, n), t[n], f"{pre}.moe.{n}")
            if "shared" in t:
                _put_mlp(block.moe.shared, t["shared"], f"{pre}.moe.shared")


def _put_mlp(mlp, tree, name: str) -> None:
    for n in ("wi", "wg", "wo"):
        if n in tree:
            _put(getattr(mlp, n), tree[n], f"{name}.{n}")


def to_reference(model: LM, leaf: Optional[Callable] = None
                 ) -> Dict[str, Any]:
    """The inverse: the port's weights as the reference's pytree of numpy
    arrays (fp32), stacked per segment as ``init_stack`` lays them out.

    ``leaf(param)`` picks what is laid out for each parameter instead of
    the parameter itself -- ``lambda p: p.grad`` for the gradients, or
    ``by_name(model, state.opt.m)`` for AdamW's first moments -- so that
    gradients and optimizer state compare leaf by leaf with the
    reference's."""
    pick = leaf if leaf is not None else (lambda p: p)
    return _reference_tree(
        model, lambda p: pick(p).detach().float().cpu().numpy(), np.stack)


def reference_paths(model: LM) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """Each parameter's name -> (its leaf's path in the reference's pytree,
    ``"stack/seg0/slot0/attn/wq"`` as ``jax.tree_util`` keys join with
    ``/``, and that leaf's shape: stacked, with the segment's repeat count
    first, where the segment scans).  Shapes only, so a model on the
    ``meta`` device will do."""
    names = {id(p): n for n, p in model.named_parameters()}
    tree = _reference_tree(model, lambda p: [(names[id(p)], tuple(p.shape))],
                           lambda per: [x for layer in per for x in layer])
    out: Dict[str, Tuple[str, Tuple[int, ...]]] = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
            return
        shape = t[0][1] if len(t) == 1 else (len(t),) + t[0][1]
        out.update({name: (path, shape) for name, _ in t})

    walk(tree, "")
    return out


def _reference_tree(model: LM, arr: Callable, stack: Callable
                    ) -> Dict[str, Any]:
    """The reference's pytree with ``arr(param)`` at each leaf and
    ``stack([leaf of each repeat])`` where a segment scans."""
    cfg = model.cfg

    def norm(m):
        out = {"scale": arr(m.scale)}
        if m.kind == "layernorm":
            out["bias"] = arr(m.bias)
        return out

    def own(m):
        return {n: arr(p) for n, p in m.named_parameters(recurse=False)}

    def block_tree(b):
        kind = b.blk if b.blk in (SSM, RGLRU) else "attn"
        mixer = getattr(b, kind)
        t = {"norm1": norm(b.norm1), kind: own(mixer)}
        if kind == SSM:
            t[kind]["norm"] = norm(mixer.norm)
        if kind == "attn" and cfg.qk_norm:
            t["attn"]["q_norm"] = norm(b.attn.q_norm)
            t["attn"]["k_norm"] = norm(b.attn.k_norm)
        if hasattr(b, "norm2"):
            t["norm2"] = norm(b.norm2)
        if hasattr(b, "mlp"):
            t["mlp"] = own(b.mlp)
        if hasattr(b, "moe"):
            t["moe"] = own(b.moe)
            if hasattr(b.moe, "shared"):
                t["moe"]["shared"] = own(b.moe.shared)
        return t

    def stack_trees(trees):
        if isinstance(trees[0], dict):
            return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
        return stack(trees)

    layers = [block_tree(b) for b in model.stack.blocks]
    stack_tree, at = {}, 0
    for si, (unit, k) in enumerate(plan_segments(cfg.pattern)):
        seg = {}
        for slot in range(len(unit)):
            per = [layers[at + rep * len(unit) + slot] for rep in range(k)]
            seg[f"slot{slot}"] = stack_trees(per) if k > 1 else per[0]
        stack_tree[f"seg{si}"] = seg
        at += k * len(unit)
    out = {"embed": {"table": arr(model.embed)}, "stack": stack_tree,
           "final_norm": norm(model.final_norm)}
    if not cfg.tie_embeddings:
        out["head"] = {"table": arr(model.head)}
    if cfg.pos_embedding == "learned":
        out["pos_embed"] = arr(model.pos_embed)
    return out


def by_name(model: LM, tensors: Mapping[str, torch.Tensor]) -> Callable:
    """A ``leaf`` for ``to_reference``: the tensor of ``tensors`` (keyed by
    parameter name, as the optimizer state is) that belongs to a parameter."""
    names = {id(p): n for n, p in model.named_parameters()}
    return lambda p: tensors[names[id(p)]]


# ---------------------------------------------------------------------------
# the paper's Table II models
# ---------------------------------------------------------------------------
def bert_from_reference(params: Mapping[str, Any], cfg: ModelConfig, *,
                        dtype=torch.float32, device="cuda") -> BertQA:
    """The port's ``BertQA`` holding ``init_bert_qa``'s weights (numpy)."""
    model = BertQA(cfg, dtype=dtype, device=require_device(device))
    _load_lm(model.lm, params, cfg)
    _put(model.segment_embed, params["segment_embed"], "segment_embed")
    _put(model.qa_head.w, params["qa_head"]["w"], "qa_head.w")
    _put(model.qa_head.b, params["qa_head"]["b"], "qa_head.b")
    return model


def bert_to_reference(model: BertQA, leaf: Optional[Callable] = None
                      ) -> Dict[str, Any]:
    """The inverse (``leaf`` as in ``to_reference``)."""
    pick = leaf if leaf is not None else (lambda p: p)

    def arr(p):
        return pick(p).detach().float().cpu().numpy()

    out = to_reference(model.lm, leaf)
    out["segment_embed"] = arr(model.segment_embed)
    out["qa_head"] = {"w": arr(model.qa_head.w), "b": arr(model.qa_head.b)}
    return out


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """A reference pytree of dicts and lists as {dotted name: leaf}; list
    items are named by their index, as ``nn.ModuleList`` names them."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def vision_from_reference(params: Mapping[str, Any], cfg: VisionConfig, *,
                          dtype=torch.float32, device="cuda") -> nn.Module:
    """The port's vision model holding ``init_vision(key, cfg)``'s weights
    (numpy) in ``dtype``: every leaf mapped by name, every shape checked,
    none left over on either side.  4-D leaves are conv weights, HWIO ->
    OIHW."""
    dev = require_device(device)
    model = vision.VISION_MODELS[cfg.arch](cfg, dtype=dtype, device=dev)
    ours = dict(model.named_parameters())
    leaves = flatten_tree(params)
    if set(leaves) != set(ours):
        raise ValueError(
            f"{cfg.name}: reference leaves without a parameter "
            f"{sorted(set(leaves) - set(ours))[:5]}, parameters without a "
            f"leaf {sorted(set(ours) - set(leaves))[:5]}")
    for name, a in leaves.items():
        a = np.asarray(a)
        _put(ours[name], a.transpose(3, 2, 0, 1) if a.ndim == 4 else a, name)
    return model


def vision_to_reference(model: nn.Module, leaf: Optional[Callable] = None
                        ) -> Dict[str, Any]:
    """The inverse: the reference's nested dicts and lists of numpy arrays
    in the parameters' dtype (fp32, or fp64 for a model cast to it), conv
    weights HWIO; ``leaf`` as in ``to_reference``."""
    pick = leaf if leaf is not None else (lambda p: p)
    root: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        a = pick(p).detach().cpu().numpy()
        node, *path, last = [root] + name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    def lists(t):
        if not isinstance(t, dict):
            return t
        if all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}

    return lists(root)
