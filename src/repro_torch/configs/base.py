"""Configuration dataclasses for models, shapes, and parallelism policies.

The port's own copy of ``repro/configs/base.py`` (framework-free); the only
difference is ``PolicyConfig.attn_impl``, whose values are ``"kernel"`` and
``"full"`` here.

Every assigned architecture gets a ``ModelConfig`` in its own module under
``repro_torch.configs``; the registry in ``repro_torch.configs.__init__`` maps arch ids
(``--arch mamba2-780m``) to configs.  Shape sets (train_4k / prefill_32k /
decode_32k / long_500k) are global for the LM family, per the assignment.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Block types that a transformer stack can be composed of.
# ---------------------------------------------------------------------------
ATTN = "attn"                # global (causal) attention
ATTN_LOCAL = "attn_local"    # sliding-window attention
SSM = "ssm"                  # Mamba-2 SSD mixer
RGLRU = "rglru"              # RG-LRU recurrent block (Griffin)

BLOCK_TYPES = (ATTN, ATTN_LOCAL, SSM, RGLRU)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0            # per shared expert
    router_jitter: float = 0.0
    # capacity factor for dropless-ish dispatch accounting (dense einsum path
    # computes all experts; EP path uses capacity buckets)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256                # SSD chunk length
    a_init_range: Tuple[float, float] = (1.0, 16.0)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0              # 0 -> d_model
    d_conv: int = 4
    c: float = 8.0                  # recurrent gate sharpness constant


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                 # 0 -> d_model // n_heads
    block_pattern: Tuple[str, ...] = ()   # () -> all ATTN
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # partial rotary (stablelm)
    local_window: int = 2048        # for ATTN_LOCAL blocks
    logit_softcap: float = 0.0
    causal: bool = True             # False -> bidirectional encoder (BERT)
    # ffn / norm details
    act: str = "swiglu"             # swiglu | geglu | gelu
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-5
    parallel_residual: bool = False # attn & ffn from same normed input
    tie_embeddings: bool = False
    pos_embedding: str = "rope"     # rope | sinusoidal | none
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # io
    input_mode: str = "tokens"      # tokens | embeddings (vlm/audio stubs)
    max_seq: int = 524_288
    # provenance
    source: str = ""

    # ---------------------------------------------------------- derived ----
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 128)

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.block_pattern:
            assert len(self.block_pattern) == self.n_layers
            return self.block_pattern
        return (ATTN,) * self.n_layers

    @property
    def attention_free(self) -> bool:
        return all(b in (SSM, RGLRU) for b in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends over unbounded (full-seq) context."""
        return all(b != ATTN for b in self.pattern)

    # ------------------------------------------------------ param counts ---
    def param_count(self) -> int:
        """Analytic parameter count (physical, incl. vocab padding)."""
        d, hd = self.d_model, self.head_dim
        n_embed = self.padded_vocab * d
        total = n_embed if self.tie_embeddings else 2 * n_embed
        for blk in self.pattern:
            total += 2 * d  # two norms per block (or one for pure mixers)
            if blk in (ATTN, ATTN_LOCAL):
                qkv = d * (self.n_heads + 2 * self.n_kv_heads) * hd
                if self.qkv_bias:
                    qkv += (self.n_heads + 2 * self.n_kv_heads) * hd
                total += qkv + self.n_heads * hd * d
            elif blk == SSM:
                total += self._ssm_params()
            elif blk == RGLRU:
                total += self._rglru_params()
            if blk in (ATTN, ATTN_LOCAL, SSM, RGLRU):
                total += self._ffn_params(blk)
        return total

    def _ffn_params(self, blk: str) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            per = 3 * d * m.d_ff_expert if self.act in ("swiglu", "geglu") \
                else 2 * d * m.d_ff_expert
            shared = m.n_shared_experts * (
                3 * d * m.d_ff_shared if self.act in ("swiglu", "geglu")
                else 2 * d * m.d_ff_shared)
            router = d * m.n_experts
            return m.n_experts * per + shared + router
        if self.d_ff == 0:
            return 0
        mult = 3 if self.act in ("swiglu", "geglu") else 2
        return mult * self.d_model * self.d_ff

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        total = self.param_count()
        per = (3 if self.act in ("swiglu", "geglu") else 2) * self.d_model * m.d_ff_expert
        n_moe_layers = sum(1 for b in self.pattern if b in (ATTN, ATTN_LOCAL, SSM, RGLRU))
        total -= n_moe_layers * (m.n_experts - m.top_k) * per
        return total

    def _ssm_params(self) -> int:
        assert self.ssm is not None
        s, d = self.ssm, self.d_model
        d_in = s.expand * d
        nheads = d_in // s.head_dim
        in_proj = d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
        conv = s.d_conv * (d_in + 2 * s.n_groups * s.d_state)
        extra = 2 * nheads + d_in   # A_log, D, dt_bias-ish + norm gate
        out_proj = d_in * d
        return in_proj + conv + extra + out_proj

    def _rglru_params(self) -> int:
        assert self.rglru is not None
        r, d = self.rglru, self.d_model
        w = r.lru_width or d
        # in: two branches d->w; conv; rg-lru gates (2 * w * w/heads... use
        # diagonal-block gates: 2 dense w->w per Griffin's block-diag approx)
        return d * w * 2 + r.d_conv * w + 2 * w * w // 8 + 2 * w + w * d


# ---------------------------------------------------------------------------
# Shapes (assignment: LM family, seq_len x global_batch)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def applicable_shapes(cfg: ModelConfig) -> Sequence[ShapeConfig]:
    """All four shapes, minus long_500k for pure full-attention archs."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out


# ---------------------------------------------------------------------------
# Parallelism / execution policy
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """How a model is laid out on a composed mesh.

    ``fsdp_axis`` shards parameters/optimizer state (ZeRO-3 analogue);
    ``dp_axes`` shard the batch; ``tp_axis`` (same physical axis as fsdp by
    default on the 2D mesh) shards experts (EP) and, when enabled, FFN/head
    dims (TP).  The paper's software-optimization ladder maps to:
      DP        -> zero_stage=0, no fsdp (params replicated)
      DDP       -> zero_stage=0 with bucketed/overlapped grad psum
      mixed     -> compute_dtype=bf16
      sharded   -> zero_stage=3 (fsdp_axis active)
    """
    dp_axes: Tuple[str, ...] = ("data",)
    fsdp_axes: Tuple[str, ...] = ("data",)
    tp_axis: Optional[str] = "model"
    ep: bool = True                 # experts over tp_axis
    tp_ffn: bool = False            # Megatron-style FFN TP (perf option)
    tp_attn_heads: bool = False     # head TP where divisible (perf option)
    sp: bool = False                # shard sequence over tp_axis in mixers
    zero_stage: int = 3             # 0|1|3
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    accum_dtype: str = "float32"
    remat: str = "block"            # none | block | full
    grad_accum: int = 1
    hierarchical_allreduce: bool = True   # fast-domain first (multi-pod)
    grad_compression: str = "none"  # none | int8_ef
    # "kernel": the hand-written CUDA kernels (flash-attention prefill,
    # paged decode); on CPU tensors their plain PyTorch versions.
    # "full": the oracle that materialises the (S, T) scores.
    # (The reference's "xla" / "pallas" names have no meaning here.)
    attn_impl: str = "kernel"
    scan_layers: bool = True
    offload_activations: bool = False


DEFAULT_POLICY = PolicyConfig()
