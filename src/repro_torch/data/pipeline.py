"""Input pipeline: synthetic batches + storage I/O workload model, held
against ``repro/data/pipeline.py``.

The paper's storage experiment (§V-3, Fig 15/16) varies where the NVMe sits
(local vs falcon-attached) and measures the effect on training step time.
The pipeline reproduces that apparatus:

  * ``SyntheticDataset``   -- deterministic token batches, per (seed, step,
    shard), numpy only, so every host makes its own shard without
    coordination; equal arguments give arrays identical to the reference's.
  * ``IOWorkload``/``IOTraceGenerator`` -- MLPerf-Storage (DLIO)-style I/O
    description and trace: per-sample record-size distributions, per-epoch
    shuffled reads, periodic checkpoint write bursts; seeded as the
    reference seeds it, so its traces are the same numbers.
  * ``StorageModel``       -- prices reads/writes against a storage tier,
    with the tranche's bandwidth partitioned across concurrent lessees
    (``data.storage``).
  * ``Prefetcher``         -- double-buffering: the read of batch t+1
    overlaps the compute of batch t; input stall = max(0, read_time -
    step_time).  Its flight time is computed, not slept, as in the
    reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.topology import (DEFAULT_LINKS, LinkClass, StorageSpec,
                                       partitioned_bw)


@dataclasses.dataclass(frozen=True)
class SyntheticDataset:
    """Deterministic LM batches: tokens ~ Zipf-ish over the vocab."""
    cfg: ModelConfig
    shape: ShapeConfig
    seed: int = 0

    def batch_at(self, step: int, *, shard: int = 0, n_shards: int = 1
                 ) -> Dict[str, np.ndarray]:
        """The (shard)th slice of the global batch for ``step``."""
        B = self.shape.global_batch // n_shards
        S = self.shape.seq_len
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        V = self.cfg.vocab_size
        # zipf-flavoured ids (clipped); cheap and stationary
        raw = rng.zipf(1.3, size=(B, S + 1))
        toks = np.minimum(raw - 1, V - 1).astype(np.int32)
        if self.cfg.input_mode == "embeddings":
            x = rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
            return {"inputs": x, "labels": toks[:, 1:S + 1]}
        return {"inputs": toks[:, :S], "labels": toks[:, 1:S + 1]}

    def batch_bytes(self) -> int:
        B, S = self.shape.global_batch, self.shape.seq_len
        if self.cfg.input_mode == "embeddings":
            return B * S * self.cfg.d_model * 4 + B * S * 4
        return B * (S + 1) * 4


# ---------------------------------------------------------------------------
# MLPerf-Storage-style I/O workloads (the DLIO workload-config shape)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class IOWorkload:
    """DLIO-style I/O description of one training workload.

    ``record_bytes``/``record_stdev`` mirror DLIO's
    ``record_length_bytes``(+``_stdev``): per-sample sizes are drawn once
    from a clipped normal and are a fixed property of the dataset;
    per-epoch shuffling reorders which sizes each step reads.
    ``checkpoint_bytes`` every ``checkpoint_every`` steps models the
    paper's Fig-9 checkpoint dips as periodic write bursts.
    """
    name: str
    record_bytes: float                  # mean bytes per sample record
    record_stdev: float = 0.0
    batch_size: int = 1                  # samples read per step (global)
    samples_per_epoch: int = 1024
    checkpoint_bytes: float = 0.0
    checkpoint_every: int = 0            # steps between bursts; 0 = never

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.samples_per_epoch // max(self.batch_size, 1))

    def mean_step_read_bytes(self) -> float:
        return self.batch_size * self.record_bytes

    def mean_step_write_bytes(self) -> float:
        if self.checkpoint_every <= 0:
            return 0.0
        return self.checkpoint_bytes / self.checkpoint_every

    def dataset_bytes(self) -> float:
        return self.samples_per_epoch * self.record_bytes


# The paper's five benchmarks as I/O workloads (replaces the former flat
# SAMPLE_BYTES dict).  Record stats: ImageNet JPEG ~110KB (long-tailed;
# stdev ~40KB), COCO 640px ~300KB +- 120KB, tokenized SQuAD ~6KB +- 1KB.
# Batch sizes are the paper's §V-C-1 points; checkpoints are one fp32
# model snapshot per epoch (DLIO's epochs_between_checkpoints=1).
def _paper_io(name: str, rec: float, stdev: float, batch: int,
              samples: int, params: float) -> IOWorkload:
    steps = max(1, samples // batch)
    return IOWorkload(name, rec, stdev, batch, samples,
                      checkpoint_bytes=params * 4.0,
                      checkpoint_every=steps)


IO_WORKLOADS: Dict[str, IOWorkload] = {
    w.name: w for w in (
        _paper_io("mobilenetv2", 110e3, 40e3, 64, 1_281_167, 3.4e6),
        _paper_io("resnet50", 110e3, 40e3, 128, 1_281_167, 25.6e6),
        _paper_io("yolov5l", 300e3, 120e3, 88, 118_287, 47e6),
        _paper_io("bert-base", 6e3, 1e3, 96, 88_524, 110e6),
        _paper_io("bert-large", 6e3, 1e3, 48, 88_524, 340e6),
    )}


def lm_io_workload(cfg: ModelConfig, shape: ShapeConfig, *,
                   samples_per_epoch: int = 1 << 20,
                   checkpoint_every: int = 50) -> IOWorkload:
    """The I/O shape of one LM job from the ``configs/`` registry.

    Tokenized records are fixed-size (stdev 0); embedding-mode archs read
    precomputed patch/frame embeddings.  Serving shapes read per-token
    (decode) or per-prompt (prefill) — no dataset sweep, no checkpoints.
    """
    S = shape.seq_len
    if shape.kind == "decode":
        rec = 4.0                        # one token id per seq per step
    elif cfg.input_mode == "embeddings":
        rec = S * cfg.d_model * 4.0 + S * 4.0
    else:
        rec = (S + 1) * 4.0
    train = shape.kind == "train"
    return IOWorkload(
        f"{cfg.name}/{shape.name}", rec, 0.0, shape.global_batch,
        samples_per_epoch,
        checkpoint_bytes=cfg.param_count() * 4.0 if train else 0.0,
        checkpoint_every=checkpoint_every if train else 0)


class IOTraceGenerator:
    """Deterministic MLPerf-Storage-style I/O trace for one workload.

    Per-sample record sizes are drawn once (clipped normal, fixed by
    ``seed``); every epoch reads the whole dataset in a fresh shuffled
    order (``file_shuffle: seed`` semantics), so the same seed yields a
    bit-identical trace and different epochs reorder the same sizes.
    """

    _MIN_FRAC = 0.05                     # record floor (DLIO resize)

    def __init__(self, workload: IOWorkload, seed: int = 0):
        self.w = workload
        self.seed = seed
        self._sizes: Optional[np.ndarray] = None
        self._epoch: Optional[int] = None
        self._order: Optional[np.ndarray] = None

    # ------------------------------------------------------------ dataset --
    def record_sizes(self) -> np.ndarray:
        """(samples_per_epoch,) bytes per sample — a dataset property."""
        if self._sizes is None:
            w = self.w
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, 0xB17E5]))
            if w.record_stdev > 0:
                raw = rng.normal(w.record_bytes, w.record_stdev,
                                 size=w.samples_per_epoch)
                self._sizes = np.maximum(raw,
                                         w.record_bytes * self._MIN_FRAC)
            else:
                self._sizes = np.full(w.samples_per_epoch,
                                      float(w.record_bytes))
        return self._sizes

    def epoch_order(self, epoch: int) -> np.ndarray:
        """Shuffled sample ids for ``epoch`` (cached for the last epoch)."""
        if self._epoch != epoch:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, 1 + epoch]))
            self._order = rng.permutation(self.w.samples_per_epoch)
            self._epoch = epoch
        return self._order

    # -------------------------------------------------------------- trace --
    def step_read_bytes(self, step: int) -> float:
        """Bytes the global batch reads at ``step`` (shuffled-epoch)."""
        w = self.w
        spe = w.steps_per_epoch
        order = self.epoch_order(step // spe)
        i = (step % spe) * w.batch_size
        ids = order[i:i + w.batch_size]
        return float(self.record_sizes()[ids].sum())

    def step_write_bytes(self, step: int) -> float:
        """Checkpoint burst bytes written *at the end of* ``step``."""
        w = self.w
        if w.checkpoint_every > 0 and (step + 1) % w.checkpoint_every == 0:
            return float(w.checkpoint_bytes)
        return 0.0

    def read_trace(self, n_steps: int, start: int = 0) -> np.ndarray:
        return np.asarray([self.step_read_bytes(start + t)
                           for t in range(n_steps)])


# ---------------------------------------------------------------------------
# storage tier pricing (the Fig-15 instrument)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StorageModel:
    """Prices reads/writes against one storage tier.

    ``n_lessees`` > 1 partitions the tier's bandwidth equally across
    co-located tenants (the tranche-sharing model of ``data.storage``);
    the default of 1 is the legacy single-tenant behaviour.
    """
    tier: StorageSpec
    links: Dict[LinkClass, Any] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_LINKS))
    n_lessees: int = 1
    write_bw: float = 1.9e9              # NVMe-class sequential write

    @classmethod
    def for_tranche(cls, pool, tranche: str) -> "StorageModel":
        """Bound to a ``StoragePool`` tranche under its live contention."""
        tr = pool.tranches[tranche]
        return cls(tr.spec(), dict(pool.links),
                   max(1, pool.n_lessees(tranche)), tr.write_bw)

    def read_time(self, nbytes: float) -> float:
        link = self.links[self.tier.attach]
        bw = partitioned_bw(self.tier.read_bw, link, self.n_lessees)
        return nbytes / bw + link.latency

    def write_time(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        link = self.links[self.tier.attach]
        bw = partitioned_bw(self.write_bw, link, self.n_lessees)
        return nbytes / bw + link.latency


def input_stall(read_s: float, step_s: float, *, prefetch: int = 2) -> float:
    """Per-step input stall with ``prefetch``-deep double buffering."""
    if prefetch >= 1:
        return max(0.0, read_s - step_s)
    return read_s


def workload_stall(io: IOWorkload, model: StorageModel, step_s: float, *,
                   prefetch: int = 2) -> float:
    """Expected per-step stall of ``io`` on ``model``'s (possibly
    contended) tier: prefetch-overlapped reads plus amortized checkpoint
    write bursts (writes block the step — the paper's Fig-9 dips)."""
    stall = input_stall(model.read_time(io.mean_step_read_bytes()), step_s,
                        prefetch=prefetch)
    if io.checkpoint_every > 0:
        stall += model.write_time(io.checkpoint_bytes) / io.checkpoint_every
    return stall


# ---------------------------------------------------------------------------
# host-side prefetcher (analytic; deterministic)
# ---------------------------------------------------------------------------
class Prefetcher:
    """Synchronous double-buffer: ``next()`` returns batch t while batch
    t+1 is 'in flight' (flight time tracked analytically, not slept)."""

    def __init__(self, ds: SyntheticDataset, storage: StorageModel, *,
                 shard: int = 0, n_shards: int = 1, depth: int = 2):
        self.ds = ds
        self.storage = storage
        self.shard = shard
        self.n_shards = n_shards
        self.depth = depth
        self._step = 0
        self._read_s = storage.read_time(ds.batch_bytes() / n_shards)

    @property
    def read_time_s(self) -> float:
        return self._read_s

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.ds.batch_at(self._step, shard=self.shard,
                             n_shards=self.n_shards)
        self._step += 1
        return b


def make_batch(cfg: ModelConfig, shape: ShapeConfig, *, step: int = 0,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """One full global batch as numpy arrays (the train step moves them to
    its device)."""
    return SyntheticDataset(cfg, shape, seed).batch_at(step)
