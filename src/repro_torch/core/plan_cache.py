# Copied verbatim from src/repro/core/plan_cache.py; keep the two in step.
"""Tenant-budgeted, cost-aware plan cache with lineage pinning + persistence.

PR 1's plan cache was a tenant-blind LRU: one flood of one-shot graphs from
any client evicted every other client's warm plans.  In a serving fleet the
cache is a shared resource with per-client quotas; this module is that
policy, factored out of ``PartitionService`` so it is independently
testable:

  * **Per-tenant byte budgets** — every entry is owned by the tenant whose
    request computed it; ``put`` enforces the owner's budget by evicting
    *that tenant's* entries only, so one tenant flooding the cache can
    never push out another tenant's warm plans (global ``max_entries`` /
    ``max_bytes`` backstops still apply, cost-scored across tenants).
  * **Cost-aware eviction** — victims are chosen by ascending
    ``score = compute_time_s / nbytes`` (seconds of recompute bought per
    byte held): a plan that is cheap to recompute but holds many bytes goes
    first, an expensive multilevel run on a big graph stays.  Ties (and the
    degenerate all-equal case) fall back to LRU order.
  * **Incremental-lineage pinning** — a churn stream repeatedly derives
    plans from one base plan (``ServicePlan.lineage`` names the base
    fingerprint); evicting the base breaks the stream with a KeyError even
    though every derived plan is cheap.  Bases referenced by cached derived
    plans are refcounted, and ``pin``/``unpin`` let the service mark a
    stream's base explicitly; pinned entries are evicted only when nothing
    unpinned remains (bounded memory still wins over a pin).
  * **Persistence** — ``save``/``load`` snapshot the cache contents (plans
    are plain dataclasses over numpy arrays, pickled with a format-version
    guard) so a restarted service starts warm instead of re-partitioning
    its whole working set.

Thread safety: every public method takes the internal lock; the lock is
reentrant so the ``PartitionService`` facade can compose calls under its
own critical sections without deadlocking.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import threading
from collections import OrderedDict
from typing import Iterable, Optional

__all__ = ["CacheEntry", "PlanCache", "TenantCacheStats",
           "PERSIST_MAGIC", "PERSIST_VERSION"]

# Public: the wire transport reuses this payload format for gossip frames.
PERSIST_MAGIC = "repro-plan-cache"
PERSIST_VERSION = 2
# Backward-compatible aliases (pre-transport name).
_PERSIST_MAGIC = PERSIST_MAGIC
_PERSIST_VERSION = PERSIST_VERSION

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class TenantCacheStats:
    """Per-tenant counters exported into the ServiceMetrics snapshot."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    entries: int = 0  # current
    bytes: int = 0  # current
    budget_bytes: Optional[int] = None


@dataclasses.dataclass
class CacheEntry:
    plan: object  # ServicePlan (kept untyped: no import cycle with the facade)
    tenant: str
    nbytes: int
    pinned: bool = False


class PlanCache:
    """Fingerprint-keyed plan cache with per-tenant byte budgets."""

    def __init__(
        self,
        max_entries: int = 64,
        max_bytes: int | None = None,
        tenant_budgets: dict[str, int] | None = None,
        default_tenant_budget: int | None = None,
    ) -> None:
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self.tenant_budgets = dict(tenant_budgets or {})
        self.default_tenant_budget = default_tenant_budget
        self._entries: OrderedDict[str, CacheEntry] = OrderedDict()  # LRU order
        self._lineage_refs: dict[str, int] = {}  # fingerprint -> #derived entries
        self._tenants: dict[str, TenantCacheStats] = {}
        self._evictions_total = 0
        self._total_bytes = 0  # running sum; O(1) per put/drop, not O(n)
        self._lock = threading.RLock()

    # -- bookkeeping helpers ----------------------------------------------

    def _tenant(self, tenant: str) -> TenantCacheStats:
        st = self._tenants.get(tenant)
        if st is None:
            st = TenantCacheStats(budget_bytes=self.budget_for(tenant))
            self._tenants[tenant] = st
        return st

    def budget_for(self, tenant: str) -> Optional[int]:
        return self.tenant_budgets.get(tenant, self.default_tenant_budget)

    def _is_pinned(self, fingerprint: str, entry: CacheEntry) -> bool:
        return entry.pinned or self._lineage_refs.get(fingerprint, 0) > 0

    @staticmethod
    def _score(entry: CacheEntry) -> float:
        # Seconds of recompute bought per byte held: evict the cheapest.
        return float(getattr(entry.plan, "compute_time_s", 0.0)) / max(entry.nbytes, 1)

    def _victim(self, candidates: Iterable[str]) -> Optional[str]:
        """Lowest-score candidate; pinned entries only if nothing else.
        Iteration follows LRU order, and strict ``<`` keeps the oldest of a
        score tie — the LRU fallback when every score is equal."""
        best = best_pinned = None
        best_s = best_pinned_s = float("inf")
        for fp in candidates:
            entry = self._entries[fp]
            s = self._score(entry)
            if self._is_pinned(fp, entry):
                if s < best_pinned_s:
                    best_pinned, best_pinned_s = fp, s
            elif s < best_s:
                best, best_s = fp, s
        return best if best is not None else best_pinned

    def _drop(self, fingerprint: str, *, evicted: bool) -> CacheEntry:
        entry = self._entries.pop(fingerprint)
        lineage = getattr(entry.plan, "lineage", None)
        if lineage is not None:
            refs = self._lineage_refs.get(lineage, 0) - 1
            if refs <= 0:
                self._lineage_refs.pop(lineage, None)
            else:
                self._lineage_refs[lineage] = refs
        st = self._tenant(entry.tenant)
        st.entries -= 1
        st.bytes -= entry.nbytes
        self._total_bytes -= entry.nbytes
        if evicted:
            st.evictions += 1
            self._evictions_total += 1
        return entry

    # -- core API ----------------------------------------------------------

    def get(self, fingerprint: str, tenant: str = "default") -> Optional[object]:
        """Warm probe: counts a hit (for ``tenant``) and refreshes recency.
        A miss is NOT counted here — in-flight coalescing means not every
        failed probe becomes a computation; the service calls
        :meth:`record_miss` when it actually schedules one."""
        with self._lock:
            entry = self._entries.get(fingerprint)
            if entry is None:
                return None
            self._entries.move_to_end(fingerprint)
            self._tenant(tenant).hits += 1
            return entry.plan

    def peek(self, fingerprint: str) -> Optional[object]:
        """Probe without touching recency or counters (for internal reads)."""
        with self._lock:
            entry = self._entries.get(fingerprint)
            return entry.plan if entry is not None else None

    def touch(self, fingerprint: str) -> bool:
        """Refresh recency without counting a hit (e.g. a churn update
        resolving its base plan is bookkeeping, not a request served)."""
        with self._lock:
            if fingerprint not in self._entries:
                return False
            self._entries.move_to_end(fingerprint)
            return True

    def record_miss(self, tenant: str = "default") -> None:
        with self._lock:
            self._tenant(tenant).misses += 1

    def put(self, plan, tenant: str = "default") -> int:
        """Insert ``plan`` owned by ``tenant``; returns the eviction count.

        Enforcement order: the owner's byte budget first (victims drawn from
        the owner's entries only — the isolation guarantee), then the global
        byte cap, then the global entry cap (both cost-scored across all
        tenants).  A plan larger than its owner's whole budget is not cached
        at all (counted as an eviction of itself): admitting it would just
        evict the tenant's entire working set for a plan that cannot stay.
        """
        fingerprint = plan.fingerprint
        nbytes = int(plan.nbytes())
        evictions = 0
        with self._lock:
            old = self._entries.get(fingerprint)
            owner = old.tenant if old is not None else tenant
            budget = self.budget_for(owner)
            if budget is not None and nbytes > budget:
                # Inadmissible replacement: keep an existing (still warm,
                # possibly pinned / lineage-anchoring) copy rather than
                # silently deleting the fingerprint; count the rejection as
                # an eviction only when there was nothing to keep.
                if old is None:
                    self._tenant(owner).evictions += 1
                    self._evictions_total += 1
                    return 1
                return 0
            if old is not None:
                dropped = self._drop(fingerprint, evicted=False)
                entry = CacheEntry(plan, tenant=dropped.tenant, nbytes=nbytes,
                                   pinned=dropped.pinned)
            else:
                entry = CacheEntry(plan, tenant=tenant, nbytes=nbytes)
            self._entries[fingerprint] = entry
            lineage = getattr(plan, "lineage", None)
            if lineage is not None:
                self._lineage_refs[lineage] = self._lineage_refs.get(lineage, 0) + 1
            st = self._tenant(entry.tenant)
            st.entries += 1
            st.bytes += nbytes
            self._total_bytes += nbytes

            if budget is not None:
                while st.bytes > budget and st.entries > 1:
                    own = [fp for fp, e in self._entries.items()
                           if e.tenant == entry.tenant and fp != fingerprint]
                    victim = self._victim(own)
                    if victim is None:
                        break
                    self._drop(victim, evicted=True)
                    evictions += 1
            if self.max_bytes is not None:
                while self._total_bytes > self.max_bytes and len(self._entries) > 1:
                    victim = self._victim(
                        fp for fp in self._entries if fp != fingerprint)
                    if victim is None:
                        break
                    self._drop(victim, evicted=True)
                    evictions += 1
            while len(self._entries) > self.max_entries:
                victim = self._victim(
                    fp for fp in self._entries if fp != fingerprint)
                if victim is None:
                    break
                self._drop(victim, evicted=True)
                evictions += 1
        return evictions

    def remove(self, fingerprint: str) -> bool:
        with self._lock:
            if fingerprint not in self._entries:
                return False
            self._drop(fingerprint, evicted=False)
            return True

    # -- pinning -----------------------------------------------------------

    def pin(self, fingerprint: str) -> bool:
        """Mark a churn stream's base plan: survives eviction while anything
        unpinned remains.  True iff the fingerprint is cached."""
        with self._lock:
            entry = self._entries.get(fingerprint)
            if entry is None:
                return False
            entry.pinned = True
            return True

    def unpin(self, fingerprint: str) -> bool:
        with self._lock:
            entry = self._entries.get(fingerprint)
            if entry is None:
                return False
            entry.pinned = False
            return True

    # -- introspection -----------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, fingerprint: str) -> bool:
        with self._lock:
            return fingerprint in self._entries

    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes

    @property
    def evictions_total(self) -> int:
        return self._evictions_total

    def fingerprints(self) -> list[str]:
        with self._lock:
            return list(self._entries)

    def pinned_fingerprints(self) -> list[str]:
        """Explicitly-pinned entries (LRU order), e.g. for a service that
        must adopt restored pins into its own bounded anchor tracking."""
        with self._lock:
            return [fp for fp, e in self._entries.items() if e.pinned]

    def tenant_stats(self) -> dict[str, TenantCacheStats]:
        """Deep-copied per-tenant counters (budget refreshed on export)."""
        with self._lock:
            out = {}
            for tenant, st in self._tenants.items():
                out[tenant] = dataclasses.replace(
                    st, budget_bytes=self.budget_for(tenant))
            return out

    # -- persistence -------------------------------------------------------

    def snapshot_payload(self, fingerprints: Iterable[str] | None = None) -> dict:
        """The persistence payload — magic + version header over
        ``(fingerprint, tenant, pinned, plan)`` entries.  ``save`` pickles
        exactly this to disk; the replica transport ships the same envelope
        as gossip frames, so both paths are validated by
        :meth:`admit_payload`.  ``fingerprints`` restricts the snapshot to
        a subset (unknown ones are skipped)."""
        with self._lock:
            if fingerprints is None:
                items = list(self._entries.items())
            else:
                items = [(fp, self._entries[fp]) for fp in fingerprints
                         if fp in self._entries]
            return {
                "magic": PERSIST_MAGIC,
                "version": PERSIST_VERSION,
                "entries": [(fp, e.tenant, e.pinned, e.plan)
                            for fp, e in items],
            }

    def admit_payload(self, payload: object, source: str = "payload") -> int:
        """Validate and admit a :meth:`snapshot_payload` envelope; returns
        the number of entries still resident afterwards.  A wrong magic or
        version fails loudly — that is a foreign or incompatible payload,
        not a corrupt one."""
        if (not isinstance(payload, dict)
                or payload.get("magic") != PERSIST_MAGIC):
            raise ValueError(f"{source} is not a plan-cache snapshot")
        if payload.get("version") != PERSIST_VERSION:
            raise ValueError(
                f"plan-cache snapshot version {payload.get('version')!r} "
                f"not supported (expected {PERSIST_VERSION})")
        with self._lock:
            for fp, tenant, pinned, plan in payload["entries"]:
                self.put(plan, tenant=tenant)
                if pinned and fp in self._entries:
                    self._entries[fp].pinned = True
            # Count at the end: a later restore can evict an earlier one
            # when the snapshot came from a bigger cache.
            return sum(
                1 for fp, *_ in payload["entries"] if fp in self._entries
            )

    def save(self, path: str) -> int:
        """Snapshot cache contents to ``path``; returns the entry count.
        Plans are dataclasses over numpy arrays — pickled with a magic +
        version header so a stale or foreign file fails loudly on load.
        The write is atomic (temp file + ``os.replace``): a crash mid-save
        leaves the previous snapshot intact, never a truncated one."""
        payload = self.snapshot_payload()
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return len(payload["entries"])

    def load(self, path: str) -> int:
        """Restore a :meth:`save` snapshot; returns the number of entries
        admitted (budgets are enforced on the way in, so a snapshot from a
        bigger cache loads its best-scored suffix).  Restored entries count
        as neither hits nor misses.

        A truncated or corrupt pickle — the signature of a crash while an
        older non-atomic writer was saving, or of disk damage — is treated
        as a cold start: log a warning and return 0.  A readable payload
        with the wrong magic/version still raises ``ValueError`` (that file
        was never ours, or needs a migration; silently ignoring it would
        mask a real configuration error)."""
        try:
            with open(path, "rb") as f:
                payload = pickle.load(f)
        except (pickle.UnpicklingError, EOFError, AttributeError,
                IndexError, MemoryError) as e:
            logger.warning(
                "plan-cache snapshot %r is truncated or corrupt (%r); "
                "starting cold", path, e)
            return 0
        return self.admit_payload(payload, source=repr(path))
