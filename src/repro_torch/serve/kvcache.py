"""Paged KV-cache manager: fixed-size pages from a shared pool, held against
``repro/serve/kvcache.py``.

  * **physical storage** -- one page pool per attention layer, shaped
    ``(n_pages + 1, page_size, K, D)`` (the ``+1`` row is a scratch page
    that absorbs masked writes), with a ``pos`` plane ``(n_pages + 1,
    page_size)`` beside it.  ``pages`` is a list with one such dict per
    layer (the reference stacks layers per scanned segment; the port's stack
    is a ``ModuleList``, so nothing is stacked and the page axis is always
    dim 0), and a page id addresses that page's tokens in *all* layers, like
    a vLLM block;
  * **block tables** -- each sequence owns an ordered list of page ids.
    Decode steps read the pool directly through the tables (the paged decode
    kernel); the dense ``(B, W, K, D)`` view exists only inside a
    prefill-chunk step (``gather_dense``);
  * **prefix reuse** -- pages are immutable once full; full prompt pages
    are registered under a chain hash (page ``i``'s key folds page
    ``i-1``'s) as soon as the prompt's prefill completes, so a request
    sharing a prompt prefix re-links the existing pages (refcount++) and
    prefill starts at the first uncached token.  Sharing granularity is
    whole pages, so only the (exclusively owned) non-full tail page of a
    sequence is ever written;
  * **free-list recycling** -- released pages return to the free list;
    hashed pages whose refcount drops to zero are *retained* in an LRU cache
    and evicted only when the free list runs dry.

The pool is updated **in place** (``index_put_`` / ``index_copy_`` /
``index_fill_``) where the reference, whose arrays are immutable, rebuilds it
with ``.at[].set``.

Only positional (full-attention) caches page cleanly, so ``PagePool``
requires an all-``attn`` block pattern.

Under a mesh's ``model`` axis each rank's pool holds ``kv_heads`` heads: the
KV heads its query heads read (``models/attention.pool_kv_heads``; zeros on
a rank of padded heads only).  The page tables, the free list and the
prefix hashes are the host's and identical on every rank: every rank runs
the same scheduler on the same requests.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.lm import require_device


class PageError(RuntimeError):
    """Pool exhausted (or a sequence outgrew its table)."""


# ---------------------------------------------------------------------------
# device-side views
# ---------------------------------------------------------------------------
def gather_dense(pages, tables):
    """Materialise the dense per-sequence cache view from the pool.

    ``tables`` (B, P) page ids (pad unused entries with the scratch page --
    its ``pos`` rows stay -1, so padded slots mask out).  Returns one
    ``{"k", "v", "pos"}`` dict per layer, batched ``(B, P*page_size, ...)``,
    as the decode/chunk paths consume.
    """
    idx = tables.long()
    B, P = idx.shape

    def g(leaf):
        out = leaf[idx]                            # (B, P, ps, rest)
        return out.reshape((B, P * out.shape[2]) + tuple(out.shape[3:]))

    return [{name: g(leaf) for name, leaf in layer.items()}
            for layer in pages]


def scatter_tokens(pages, dense, tables, positions, valid, page_size: int,
                   trash: int):
    """Write the tokens at ``positions`` (B, S) from the dense view back
    into their pages, in place; entries with ``valid`` False (padding
    rows/tails) are routed to the scratch page with ``pos=-1`` so pool state
    is untouched.  Slot == absolute position (full-attention layout)."""
    B, S = positions.shape
    pos_l = positions.long()
    bidx = torch.arange(B, device=positions.device)[:, None]
    page = torch.where(valid, tables.long()[bidx, pos_l // page_size],
                       trash)
    off = pos_l % page_size
    pos_val = torch.where(valid, positions, -1)
    for player, dlayer in zip(pages, dense):
        player["pos"].index_put_((page, off),
                                 pos_val.to(player["pos"].dtype))
        for name in ("k", "v"):
            val = dlayer[name][bidx, pos_l]        # (B, S, K, D)
            player[name].index_put_((page, off),
                                    val.to(player[name].dtype))
    return pages


def scatter_slot(caches, one, slot: int):
    """Write a single-sequence cache (one dict per layer) into batch slot
    ``slot`` of a dense slot cache, in place -- the dense engines' prefill
    scatter (shared by ``ServeEngine`` and ``AsyncServeEngine``'s dense
    mode).  Each leaf takes the slot's dtype: the recurrent blocks' conv
    tails come out of prefill in the compute dtype and live in fp32 slots,
    as in the reference (``init_block_cache`` makes them without a dtype).
    Ring (windowed) caches have ``min(local_window, max_seq)`` slots on both
    sides."""
    for c_all, c_one in zip(caches, one):
        for name, leaf in c_all.items():
            leaf[slot:slot + 1] = c_one[name].to(leaf.dtype)
    return caches


# ---------------------------------------------------------------------------
# host-side accounting
# ---------------------------------------------------------------------------
class BlockTable:
    """One sequence's ordered page ids + logical token length."""

    __slots__ = ("pages", "n_tokens")

    def __init__(self, pages: Optional[List[int]] = None, n_tokens: int = 0):
        self.pages = list(pages or [])
        self.n_tokens = n_tokens

    def __len__(self) -> int:
        return len(self.pages)


class PagePool:
    """Shared page pool: device arrays + free list + prefix-hash table."""

    def __init__(self, cfg: ModelConfig, *, n_pages: int, page_size: int = 16,
                 dtype=torch.float32, device="cuda",
                 kv_heads: Optional[int] = None):
        if any(b != ATTN for b in cfg.pattern):
            raise ValueError(
                "PagePool requires an all-'attn' block pattern; "
                f"{cfg.name} has {sorted(set(cfg.pattern))} "
                "(use the dense slot engine for ring/recurrent caches)")
        self.cfg = cfg
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.trash = self.n_pages                  # scratch row
        self.device = require_device(device)
        if kv_heads is not None:
            cfg = dataclasses.replace(cfg, n_kv_heads=int(kv_heads))
        self.pages = transformer.init_stack_cache(
            cfg, self.n_pages + 1, self.page_size, dtype, self.device)
        self.free: deque = deque(range(self.n_pages))
        self.ref = [0] * self.n_pages
        self.page_hash: List[Optional[int]] = [None] * self.n_pages
        # exact (prev_hash, tokens) key per hashed page: hits verify the
        # token content, so a 64-bit chain-hash collision degrades to a
        # miss instead of silently re-linking the wrong KV pages
        self.page_key: List[Optional[Tuple]] = [None] * self.n_pages
        self.by_hash: Dict[int, int] = {}          # hash -> page (live)
        self.retained: "OrderedDict[int, int]" = OrderedDict()  # LRU, ref==0
        # stats
        self.hit_tokens = 0
        self.miss_tokens = 0
        self.evictions = 0
        self.allocations = 0
        self.peak_in_use = 0           # high-water mark of in_use

    # ------------------------------------------------------------- sizing --
    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    @property
    def n_free(self) -> int:
        return len(self.free) + len(self.retained)

    @property
    def in_use(self) -> int:
        return self.n_pages - self.n_free

    def utilization(self) -> float:
        return self.in_use / max(self.n_pages, 1)

    def hit_rate(self) -> float:
        tot = self.hit_tokens + self.miss_tokens
        return self.hit_tokens / tot if tot else 0.0

    # -------------------------------------------------------- page lifecycle
    def _evict_one(self) -> int:
        if not self.retained:
            raise PageError(f"page pool exhausted ({self.n_pages} pages)")
        h, page = self.retained.popitem(last=False)   # LRU
        self.by_hash.pop(h, None)
        self.page_hash[page] = None
        self.page_key[page] = None
        self.evictions += 1
        return page

    def _note_usage(self) -> None:
        """Record the in-use high-water mark (the serve_bench artifact
        samples ``stats()`` post-drain, where ``in_use`` is always 0 —
        peak is the occupancy number that actually means something)."""
        if self.in_use > self.peak_in_use:
            self.peak_in_use = self.in_use

    def _take_page(self) -> int:
        page = self.free.popleft() if self.free else self._evict_one()
        self.ref[page] = 1
        self.allocations += 1
        self._note_usage()
        return page

    def allocate(self, n: int) -> List[int]:
        """``n`` fresh exclusive pages (evicting retained LRU pages as
        needed); raises PageError when the pool cannot satisfy it."""
        if n > self.n_free:
            raise PageError(
                f"need {n} pages, {self.n_free} available "
                f"({self.n_pages} total)")
        out = [self._take_page() for _ in range(n)]
        self._reset_pos(out)
        return out

    def release(self, table: BlockTable) -> None:
        """Drop one reference per page; hashed full pages are retained
        (LRU) for prefix reuse, the rest return to the free list."""
        for page in table.pages:
            self.ref[page] -= 1
            if self.ref[page] > 0:
                continue
            h = self.page_hash[page]
            if h is not None:
                self.retained[h] = page
                self.retained.move_to_end(h)
            else:
                self.free.append(page)
        table.pages = []
        table.n_tokens = 0

    def _reset_pos(self, page_ids: Sequence[int]) -> None:
        """Clear stale ``pos`` rows of recycled pages (in-place device
        write).  K/V contents can stay -- ``pos == -1`` masks them on the
        dense-view path, and the paged decode kernel reads no slot at or
        past a sequence's length."""
        if not page_ids:
            return
        idx = torch.as_tensor(list(page_ids), dtype=torch.long,
                              device=self.device)
        for layer in self.pages:
            layer["pos"].index_fill_(0, idx, -1)

    # ---------------------------------------------------------- prefix reuse
    @staticmethod
    def _chain(prev: int, toks: Tuple[int, ...]) -> int:
        return hash((prev, toks))

    def match_prefix(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest run of already-cached *full* pages covering the prompt's
        head.  Returns (page ids, n_cached_tokens); the returned pages are
        referenced (the caller owns one ref each) and counted as hits.

        Never matches the prompt's final page even when the prompt length
        is an exact page multiple: the last page must stay writable for
        the decode tail, and shared pages are immutable.
        """
        ps = self.page_size
        toks = [int(t) for t in prompt]
        pages: List[int] = []
        h = 0
        n_full = (len(toks) - 1) // ps             # final page excluded
        prev = 0
        for i in range(n_full):
            key = (prev, tuple(toks[i * ps:(i + 1) * ps]))
            h = self._chain(*key)
            page = self.by_hash.get(h)
            if page is None or self.page_key[page] != key:
                break                              # miss (or hash collision)
            # a referenced page must not sit in the eviction LRU — a
            # retained hit revives it out of the evictable set
            self.retained.pop(h, None)
            self.ref[page] += 1
            pages.append(page)
            prev = h
        self._note_usage()             # retained revivals raise in_use too
        self.hit_tokens += len(pages) * ps
        self.miss_tokens += len(toks) - len(pages) * ps
        return pages, len(pages) * ps

    def register_prefix(self, prompt: Sequence[int], table: BlockTable
                        ) -> None:
        """Hash the prompt's full pages (call once the prompt's prefill
        completes — they are immutable from then on) so later requests
        can re-link them (idempotent; first registration wins)."""
        ps = self.page_size
        toks = [int(t) for t in prompt]
        prev = 0
        for i in range((len(toks) - 1) // ps):
            key = (prev, tuple(toks[i * ps:(i + 1) * ps]))
            h = self._chain(*key)
            page = table.pages[i]
            if h not in self.by_hash and self.page_hash[page] is None:
                self.by_hash[h] = page
                self.page_hash[page] = h
                self.page_key[page] = key
            prev = h

    # ------------------------------------------------------------- sequences
    def open_sequence(self, prompt: Sequence[int], max_new: int
                      ) -> Tuple[BlockTable, int]:
        """Block table for prompt + decode budget, reusing cached prefix
        pages.  Returns (table, n_cached_tokens); raises PageError (with
        the reused refs rolled back) when the pool cannot host it."""
        reused, n_cached = self.match_prefix(prompt)
        need = self.pages_for(len(prompt) + max_new) - len(reused)
        try:
            fresh = self.allocate(need)
        except PageError:
            self.release(BlockTable(reused))
            # undo the optimistic hit accounting: the request never ran
            self.hit_tokens -= n_cached
            self.miss_tokens -= len(prompt) - n_cached
            raise
        return BlockTable(reused + fresh, n_cached), n_cached

    def close_sequence(self, prompt: Sequence[int], table: BlockTable
                       ) -> None:
        """Register the prompt's pages for reuse, then drop the refs."""
        self.register_prefix(prompt, table)
        self.release(table)

    def padded_table(self, table: BlockTable, width: int) -> List[int]:
        """``width`` page ids padded with the scratch page (a host list: the
        engine stacks a batch of them into one device tensor)."""
        return table.pages[:width] + [self.trash] * (width - len(table))

    def stats(self) -> Dict[str, float]:
        return {
            "n_pages": self.n_pages,
            "page_size": self.page_size,
            "in_use": self.in_use,
            "retained": len(self.retained),
            "utilization": self.utilization(),
            "peak_in_use": self.peak_in_use,
            "peak_utilization": self.peak_in_use / max(self.n_pages, 1),
            "hit_tokens": self.hit_tokens,
            "miss_tokens": self.miss_tokens,
            "hit_rate": self.hit_rate(),
            "evictions": self.evictions,
            "allocations": self.allocations,
        }
