"""LRU cache for ranked PPR query results (a copy of
`repro.serve.result_cache`).

Keys are (graph name, graph epoch, seed tuple, c, tol) tuples — the first
element MUST be the graph name; the cache maintains a per-graph key index on
it. The epoch makes every edge-update batch an implicit cache flush for that
graph — a stale entry's key can never be constructed again.
`invalidate_graph` additionally purges the dead entries eagerly so capacity
isn't wasted on unreachable keys; thanks to the per-graph index that purge
is O(entries for that graph), not a full O(capacity) dict scan, so
high-churn graphs (frequent edge-update batches) don't stall the tick loop.

`invalidate_selective` is the update-path alternative to the blanket purge:
entries the caller marks as perturbed (seed sets near the edge delta) are
dropped, and every other entry is RE-STAMPED to the new epoch — same value,
key rebuilt with the new epoch — instead of flushed. Undirected PageRank is
degree-dominated with a bounded correction (Grolmusz), so a localized edge
delta moves scores locally and far-from-delta entries stay servable;
retention is a deliberate approximation the service can tighten with its
re-solve tick. Re-stamped entries are touched to most-recent, which is the
LRU-honest reading of "this entry just survived an update".

Values are (indices, scores) arrays of the service-level max_top_k; queries
asking for a smaller k slice the cached arrays, so one entry serves every
top_k <= max_top_k at that operating point.
"""
from __future__ import annotations

from collections import OrderedDict

__all__ = ["ResultCache"]


class ResultCache:
    """Bounded LRU of ranked PPR answers, keyed by
    (graph, epoch, seeds, c, tol), with a per-graph invalidation index.

    Args:
        capacity: maximum live entries; 0 (or negative) disables caching
            entirely — `put` becomes a no-op and every lookup misses.

    Invariant: `_by_graph` mirrors `_d` exactly (every live key appears
    under its graph, no dead keys linger), so graph-wide invalidation is
    O(entries for that graph), never a full-capacity scan.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: OrderedDict = OrderedDict()
        # graph name -> set of live keys for it (kept exactly in sync with
        # _d by put/eviction/invalidation; the O(1)-per-key invalidation
        # index)
        self._by_graph: dict = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.retained = 0

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key, count: bool = True):
        """Lookup with LRU touch; count=False skips the hit/miss counters.
        Direct callers use this; the serving layer uses `lookup` +
        `count_hit`/`count_miss` instead so each QUERY moves the counters
        exactly once, at disposition time."""
        if key in self._d:
            self._d.move_to_end(key)
            if count:
                self.hits += 1
            return self._d[key]
        if count:
            self.misses += 1
        return None

    def lookup(self, key):
        """LRU-touching lookup that never moves the hit/miss counters.

        A served query's lookup history is not its disposition: a query can
        miss at submit and then hit at tick time (an identical in-flight
        twin filled the cache in between). The service therefore probes
        with `lookup` and settles the books once per query with `count_hit`
        (answered from cache, wherever that happened) or `count_miss`
        (answered by a solve) — so `hits + misses` equals queries answered,
        not probes made.
        """
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return None

    def count_hit(self, n: int = 1) -> None:
        """Settle `n` queries' disposition as served-from-cache (pairs with
        `lookup`, which never counts)."""
        self.hits += n

    def count_miss(self, n: int = 1) -> None:
        """Settle `n` queries' disposition as answered-by-solve."""
        self.misses += n

    def _index_discard(self, key) -> None:
        live = self._by_graph.get(key[0])
        if live is not None:
            live.discard(key)
            if not live:
                del self._by_graph[key[0]]

    def put(self, key, value) -> None:
        """Insert (or refresh) one entry, evicting least-recent entries
        past capacity. No-op when caching is disabled (capacity <= 0)."""
        if self.capacity <= 0:
            return
        if key in self._d:
            self._d.move_to_end(key)
        else:
            self._by_graph.setdefault(key[0], set()).add(key)
        self._d[key] = value
        while len(self._d) > self.capacity:
            dead, _ = self._d.popitem(last=False)
            self._index_discard(dead)
            self.evictions += 1

    def count_for(self, graph: str) -> int:
        """Live entry count for `graph` — lets the update path skip
        invalidation work (hop-mask BFS included) when there is nothing to
        invalidate."""
        return len(self._by_graph.get(graph, ()))

    def invalidate_graph(self, graph: str) -> int:
        """Drop every entry for `graph` (any epoch). Returns the count."""
        dead = self._by_graph.pop(graph, ())
        for k in dead:
            del self._d[k]
        self.invalidations += len(dead)
        return len(dead)

    def invalidate_selective(self, graph: str, new_epoch: int,
                             drop) -> tuple[int, list]:
        """Selective update-path invalidation for `graph`.

        drop: callable(key) -> bool. Entries where it returns True are
        purged; the rest are re-stamped under
        (graph, new_epoch, *key[2:]) — value kept, entry moved to
        most-recent — so they stay servable across the epoch bump. Returns
        (dropped_count, retained_new_keys); the caller uses the retained
        keys to schedule re-solve refreshes. O(entries for that graph).
        """
        keys = self._by_graph.pop(graph, ())
        dropped = 0
        seen: set = set()
        retained_keys: list = []
        for k in keys:
            val = self._d.pop(k)
            if drop(k):
                dropped += 1
                continue
            nk = (graph, new_epoch) + tuple(k[2:])
            self._d[nk] = val
            if nk not in seen:     # two stale epochs can collapse to one key
                seen.add(nk)
                retained_keys.append(nk)
        if retained_keys:
            self._by_graph[graph] = seen
        self.invalidations += dropped
        self.retained += len(retained_keys)
        return dropped, retained_keys

    def stats(self) -> dict:
        """Point-in-time counter dict: size, capacity, hits, misses,
        evictions, invalidations, retained."""
        return {"size": len(self._d), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "retained": self.retained}
