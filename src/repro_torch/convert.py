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
mixers' leaves under the reference's names), so leaves are copied, not
transposed.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import RGLRU, SSM, ModelConfig
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
    dev = require_device(device)
    model = LM(cfg, dtype=dtype, device=dev)
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
        if "mlp" in tree:
            if not cfg.parallel_residual:
                _put_norm(block.norm2, tree["norm2"], f"{pre}.norm2")
            for n in ("wi", "wg", "wo"):
                if n in tree["mlp"]:
                    _put(getattr(block.mlp, n), tree["mlp"][n],
                         f"{pre}.mlp.{n}")
    return model


def to_reference(model: LM, leaf: Optional[Callable] = None
                 ) -> Dict[str, Any]:
    """The inverse: the port's weights as the reference's pytree of numpy
    arrays (fp32), stacked per segment as ``init_stack`` lays them out.

    ``leaf(param)`` picks what is laid out for each parameter instead of
    the parameter itself -- ``lambda p: p.grad`` for the gradients, or
    ``by_name(model, state.opt.m)`` for AdamW's first moments -- so that
    gradients and optimizer state compare leaf by leaf with the
    reference's."""
    cfg = model.cfg
    pick = leaf if leaf is not None else (lambda p: p)

    def arr(p):
        return pick(p).detach().float().cpu().numpy()

    def norm(m):
        out = {"scale": arr(m.scale)}
        if m.kind == "layernorm":
            out["bias"] = arr(m.bias)
        return out

    def block_tree(b):
        kind = b.blk if b.blk in (SSM, RGLRU) else "attn"
        mixer = getattr(b, kind)
        t = {"norm1": norm(b.norm1),
             kind: {n: arr(p) for n, p in
                    mixer.named_parameters(recurse=False)}}
        if kind == SSM:
            t[kind]["norm"] = norm(mixer.norm)
        if kind == "attn" and cfg.qk_norm:
            t["attn"]["q_norm"] = norm(b.attn.q_norm)
            t["attn"]["k_norm"] = norm(b.attn.k_norm)
        if hasattr(b, "mlp"):
            if not cfg.parallel_residual:
                t["norm2"] = norm(b.norm2)
            t["mlp"] = {n: arr(p) for n, p in
                        b.mlp.named_parameters(recurse=False)}
        return t

    def stack_trees(trees):
        if isinstance(trees[0], dict):
            return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    layers = [block_tree(b) for b in model.stack.blocks]
    stack, at = {}, 0
    for si, (unit, k) in enumerate(plan_segments(cfg.pattern)):
        seg = {}
        for slot in range(len(unit)):
            per = [layers[at + rep * len(unit) + slot] for rep in range(k)]
            seg[f"slot{slot}"] = stack_trees(per) if k > 1 else per[0]
        stack[f"seg{si}"] = seg
        at += k * len(unit)
    out = {"embed": {"table": arr(model.embed)}, "stack": stack,
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
