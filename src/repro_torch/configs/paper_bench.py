"""The paper's own five DL benchmarks (Table II), as configurations.

| benchmark    | domain | params | depth |
|--------------|--------|--------|-------|
| MobileNetV2  | vision |  3.4M  |  53   |
| ResNet-50    | vision | 25.6M  |  50   |
| YOLOv5-L     | vision |   47M  | 392   |
| BERT-base    | NLP QA |  110M  |  12   |
| BERT-large   | NLP QA |  340M  |  24   |

The vision models take a ``VisionConfig`` (``repro_torch.models.vision``:
``ResNet50``, ``MobileNetV2``, ``YOLOv5L``, built by ``init_vision``); BERT
reuses ``ModelConfig`` with ``causal=False`` + learned positions
(``repro_torch.models.bert.BertQA``: the port's ``LM`` plus the segment
embedding and the QA head).  ``PAPER_WORKLOADS`` records the paper's batch
sizes and image / sequence sizes (§V-C-1); ``chip_smoke.py``'s
``paper_bench`` phase trains each workload at its point on one card (with a
stated cut where the batch does not fit).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ModelConfig, ATTN


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    name: str
    arch: str                  # resnet50 | mobilenetv2 | yolov5l
    image_size: int
    num_classes: int
    width_mult: float = 1.0


RESNET50 = VisionConfig("resnet50", "resnet50", 224, 1000)
MOBILENETV2 = VisionConfig("mobilenetv2", "mobilenetv2", 224, 1000)
YOLOV5L = VisionConfig("yolov5l", "yolov5l", 640, 80)

BERT_BASE = ModelConfig(
    name="bert-base",
    family="nlp-encoder",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    block_pattern=(ATTN,) * 12,
    act="gelu",
    norm="layernorm",
    causal=False,
    pos_embedding="learned",
    qkv_bias=True,
    tie_embeddings=True,
    max_seq=512,
    source="arXiv:1810.04805",
)

BERT_LARGE = dataclasses.replace(
    BERT_BASE,
    name="bert-large",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    block_pattern=(ATTN,) * 24,
)

# Paper §V-C-1 workload points (per-benchmark batch size & seq/image size).
@dataclasses.dataclass(frozen=True)
class PaperWorkload:
    name: str
    batch_size: int        # per the paper (global, 8 GPUs)
    seq_or_img: int
    params_paper: float    # parameter count claimed by paper Table II
    domain: str


PAPER_WORKLOADS: Tuple[PaperWorkload, ...] = (
    PaperWorkload("mobilenetv2", 64, 224, 3.4e6, "vision"),
    PaperWorkload("resnet50", 128, 224, 25.6e6, "vision"),
    PaperWorkload("yolov5l", 88, 640, 47e6, "vision"),
    PaperWorkload("bert-base", 96, 384, 110e6, "nlp"),
    PaperWorkload("bert-large", 48, 384, 340e6, "nlp"),
)
