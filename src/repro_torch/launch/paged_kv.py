"""Bank-aligned paged KV block table for the serve engine.

Port of `repro.launch.paged_kv`. The dense [slots, max_len, ...] cache the decode step computes on stays as
it is; this module adds the residency model over it: an in-flight
request's KV is held in the CiM array as fixed-size blocks of rows, each
pinned to bank `block_id % banks`, claimed from the shared `ResidentSet` as
non-evictable reservations, so pressure surfaces as a failed allocation
(the engine then defers admission) instead of an eviction. On a bank
failover `migrate` moves every block off the dead banks, all or nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.cim.array import ArraySpec, DEFAULT_SPEC, ResidentSet
from repro_torch.cim.opset import CimOpError


@dataclasses.dataclass
class PagedStats:
    n_blocks: int
    block_tokens: int
    blocks_in_use: int
    peak_blocks: int
    failed_allocs: int

    @property
    def utilization(self) -> float:
        return self.blocks_in_use / max(1, self.n_blocks)


class PagedKV:
    """Fixed-pool block table: `n_blocks` blocks of `block_tokens` tokens.

    Each block reserves `kv_bits` rows (the bit-planes of its token words)
    in bank `block_id % spec.banks` of the shared ResidentSet.
    """

    def __init__(self, spec: Optional[ArraySpec] = None, n_blocks: int = 64,
                 block_tokens: int = 16, kv_bits: int = 16,
                 resident_set: Optional[ResidentSet] = None):
        self.spec = spec or DEFAULT_SPEC
        self.n_blocks = int(n_blocks)
        self.block_tokens = int(block_tokens)
        self.kv_bits = int(kv_bits)
        self.rs = resident_set
        self._free: List[int] = list(range(self.n_blocks))
        # request id -> ordered block ids; lengths in tokens
        self.tables: Dict[int, List[int]] = {}
        self.lengths: Dict[int, int] = {}
        self.peak_blocks = 0
        self.failed_allocs = 0

    @classmethod
    def for_model(cls, cfg, spec: Optional[ArraySpec] = None,
                  slots: int = 4, max_len: int = 64,
                  kv_bits: int = 16,
                  resident_set: Optional[ResidentSet] = None) -> "PagedKV":
        """Size the pool for `slots` concurrent requests of `max_len`
        tokens: one token's KV is 2 * kv_dim * n_layers words, and a block
        holds as many tokens as fit one tile of the array."""
        spec = spec or DEFAULT_SPEC
        words_per_token = max(1, 2 * cfg.kv_dim * cfg.n_layers)
        block_tokens = max(1, spec.tile_words // words_per_token)
        per_req = -(-max_len // block_tokens)
        return cls(spec=spec, n_blocks=slots * per_req,
                   block_tokens=block_tokens, kv_bits=kv_bits,
                   resident_set=resident_set)

    # -- block lifecycle -----------------------------------------------------

    def bank_of_block(self, bid: int) -> int:
        """Round-robin over the live banks only: a degraded spec skips its
        dead banks, so new reservations never land on failed hardware."""
        live = self.spec.enabled_banks
        return live[bid % len(live)]

    def _claim(self, rid: int) -> bool:
        if not self._free:
            return False
        bid = self._free.pop(0)
        if self.rs is not None:
            try:
                self.rs.reserve(("kv", bid), self.kv_bits,
                                bank=self.bank_of_block(bid),
                                words32=self.block_tokens * self.kv_bits / 32.0)
            except CimOpError:
                self._free.insert(0, bid)
                return False
        self.tables[rid].append(bid)
        return True

    def alloc(self, rid: int, n_tokens: int) -> bool:
        """Claim blocks for a new request's first `n_tokens` (the prefill).
        All-or-nothing: a partial claim is rolled back."""
        if rid in self.tables:
            raise ValueError(f"request {rid} already has a block table")
        need = max(1, -(-n_tokens // self.block_tokens))
        self.tables[rid] = []
        self.lengths[rid] = 0
        for _ in range(need):
            if not self._claim(rid):
                self.free(rid)
                self.failed_allocs += 1
                return False
        self.lengths[rid] = n_tokens
        self.peak_blocks = max(self.peak_blocks, self.blocks_in_use)
        return True

    def extend(self, rid: int, n_tokens: int = 1) -> bool:
        """Grow a request by `n_tokens` decoded tokens, claiming a new
        block whenever the last one fills."""
        if rid not in self.tables:
            raise ValueError(f"request {rid} has no block table")
        new_len = self.lengths[rid] + n_tokens
        need = -(-new_len // self.block_tokens) - len(self.tables[rid])
        for _ in range(max(0, need)):
            if not self._claim(rid):
                self.failed_allocs += 1
                return False
        self.lengths[rid] = new_len
        self.peak_blocks = max(self.peak_blocks, self.blocks_in_use)
        return True

    def free(self, rid: int) -> None:
        """Return a retired request's blocks to the pool."""
        for bid in self.tables.pop(rid, []):
            if self.rs is not None:
                self.rs.release(("kv", bid))
            self._free.append(bid)
        self.lengths.pop(rid, None)
        self._free.sort()

    # -- failover ------------------------------------------------------------

    def migrate(self, new_spec: ArraySpec,
                new_rs: Optional[ResidentSet] = None) -> int:
        """Move every in-use block off the banks `new_spec` disables.

        All or nothing: each block is re-reserved in `new_rs` (or the
        current set) under the live-bank mapping of `new_spec` first; only
        when every block lands does the table release the old reservations
        and adopt the new spec and set. A failed re-reserve rolls back every
        reservation made so far, leaves the table untouched and raises.
        Returns the number of blocks migrated."""
        target = new_rs if new_rs is not None else self.rs
        in_use = sorted(bid for blocks in self.tables.values()
                        for bid in blocks)
        live = new_spec.enabled_banks
        if target is not None:
            placed: List[int] = []
            try:
                for bid in in_use:
                    target.reserve(("kv_mig", bid), self.kv_bits,
                                   bank=live[bid % len(live)],
                                   words32=(self.block_tokens
                                            * self.kv_bits / 32.0))
                    placed.append(bid)
            except Exception:
                for bid in placed:
                    target.release(("kv_mig", bid))
                raise
            # commit: drop the old claims, rename the staged ones
            for bid in in_use:
                if self.rs is not None:
                    self.rs.release(("kv", bid))
            for bid in in_use:
                entry = target._entries.pop(("kv_mig", bid))
                entry.key = ("kv", bid)
                target._entries[("kv", bid)] = entry
        self.spec = new_spec
        self.rs = target
        return len(in_use)

    # -- reporting -----------------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - len(self._free)

    def stats(self) -> PagedStats:
        return PagedStats(n_blocks=self.n_blocks,
                          block_tokens=self.block_tokens,
                          blocks_in_use=self.blocks_in_use,
                          peak_blocks=self.peak_blocks,
                          failed_allocs=self.failed_allocs)
