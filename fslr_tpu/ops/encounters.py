"""Device-side encounter enumeration for breakpoint clustering.

The reference's ``query_interval_trees`` walks every interval's overlap
list in Python (/root/reference/fslr/cluster.py:187-227).  Its encounter
stream is quadratic in recurrent-breakpoint group size — the round-1 scale
wall: at 100k reads the host enumeration+reduction dominated the whole
pipeline.  This module moves the stream onto the device:

  1. encounters are never materialized host-side: a slice of the global
     encounter range [g0, g0+T) is expanded ON DEVICE — the query interval
     of encounter ``g`` falls out of a scatter+cumsum over the per-interval
     neighbor-count prefix sums (no binary search), the neighbor from an
     offset gather;
  2. each slice reduces to per-pair first-encounter keys with ONE
     lexicographic (pair_key, traversal_key) sort + group-first
     compaction;
  3. per-slice uniques are merged incrementally on device (bounded HBM),
     deduped again, gated by the qlen2/n_alignments ratio test, ordered by
     traversal key, and kept DEVICE-RESIDENT: the walk fetches only the
     windows it touches (the edge cap means that is typically ~1% of
     entries), so host memory and device-to-host transfers scale with
     touched entries, not with the quadratic pair count.

The gate ratio test is float64 division on the host
(cluster.py:178-183).  The device computes in float32: a banded
verdict (definitely-pass / definitely-fail with a 1e-5 margin around the
thresholds — integer-valued inputs give float32 ratios exact to ~1e-7)
and the rare borderline entries are resolved exactly on host in float64.

Traversal-key semantics replicate stages/cluster.query_graph exactly:
tv = (query_read * max_itv + interval_rank) * max_nc + neighbor_position,
minimized per unordered pair — the pair is "seen" at its globally first
encounter (seen_edges dedup, cluster.py:205-207).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from fslr_tpu import instrument

BIG = np.int64(np.iinfo(np.int64).max)
_GATE_EPS = 1e-5

# pow2 buckets for padded shapes (bounded compile counts)
_T_BUCKETS = tuple(1 << s for s in range(14, 26))


def _bucket(n: int, buckets=_T_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:        # beyond the table: keep doubling (exact pow2)
        b *= 2
    return b


def _jit(**kw):
    import jax
    return functools.partial(jax.jit, **kw)


@dataclasses.dataclass
class ChromJob:
    """Host-side per-chromosome interval-join arrays (already sorted by
    start; lo/counts from the prefix-max overlap window, exactly the
    arrays stages/cluster._ChromIndex produces)."""
    starts: np.ndarray      # (NC,) int32/int64 interval starts
    ends: np.ndarray        # (NC,) interval ends
    lo: np.ndarray          # (NC,) first candidate neighbor position
    ccum: np.ndarray        # (NC+1,) int64 cumulative neighbor counts
    rid: np.ndarray         # (NC,) int64 read id per interval
    irk: np.ndarray         # (NC,) int64 interval rank within its read


# Pair state is 12 bytes: pk (int64, min*R+max) + sk (int32,
# side_flag*2^30 + interval_rank*max_nc + neighbor_pos).  Within a pk
# group, (sk) orders exactly like the traversal key (query read is min or
# max of the pair -> the side flag; then rank, then neighbor position), so
# lexicographic (pk, sk) sorts put each pair's FIRST global encounter at
# its group head.  The full int64 traversal key rebuilds arithmetically.
# Requires max_itv * max_nc < 2^30 (checked; the 2-core host path handles
# pathological datasets beyond it).
_SK_FLAG = 1 << 30
_SK_BIG = np.int32(2**31 - 1)


def _scatter_compact(jnp, pk_s, sk_s, first, N):
    """Compact the flagged (pk-sorted) entries to the front, BIG-filled
    tail.  Implemented as mask + re-sort instead of a scatter: dropped
    rows become BIG and the sort floats them to the tail, leaving the kept
    rows in their original (sorted, unique) order."""
    import jax
    pk_m = jnp.where(first, pk_s, jnp.int64(BIG))
    sk_m = jnp.where(first, sk_s, _SK_BIG)
    return jax.lax.sort((pk_m, sk_m), num_keys=2)


@functools.lru_cache(maxsize=None)
def _enum_reduce_fn(T: int):
    import jax
    import jax.numpy as jnp

    @_jit(static_argnames=())
    def fn(ccum, lo, starts, ends, rid, irk, g0, tot, nc_real,
           R, max_nc):
        # The query interval owning encounter g0+j is a SORTED step
        # function of j (ccum is a prefix sum), so every per-query table
        # lookup is a segment fill: scatter the table's consecutive
        # DELTAS at each interval's first encounter position, cumsum, and
        # the partial sums ARE table[qx] — a 2^17-point scatter + cumsum
        # (~0.05 s) replaces each 2^25-row gather (~0.3 s measured).
        # per-interval step positions (ccum has one extra prefix entry)
        pos = jnp.clip(ccum[:-1] - g0, 0, T).astype(jnp.int32)

        def segfill(V):
            D = V - jnp.concatenate(
                [jnp.zeros(1, V.dtype), V[:-1]])
            acc = jnp.zeros(T + 1, V.dtype).at[pos].add(D)
            return jnp.cumsum(acc[:T])

        j = jnp.arange(T, dtype=jnp.int64)
        valid = j < tot
        g = g0 + j
        lo_q = segfill(lo)
        ccum_q = segfill(ccum[:-1])
        st_q = segfill(starts)
        a32 = segfill(rid)
        irk_q = segfill(irk)
        nx = lo_q.astype(jnp.int64) + (g - ccum_q)
        nx_c = jnp.clip(nx, 0, (nc_real - 1).astype(jnp.int64))
        # neighbor side is NOT sorted — one gather of a PACKED
        # (read id, end) table instead of two
        pn = rid.astype(jnp.int64) * jnp.int64(1 << 32) \
            + ends.astype(jnp.int64)
        pn_g = pn[nx_c]
        b = pn_g // jnp.int64(1 << 32)
        keep = valid & (pn_g % jnp.int64(1 << 32) >= st_q.astype(
            jnp.int64))
        a = a32.astype(jnp.int64)
        keep &= a != b
        pk = jnp.minimum(a, b) * R + jnp.maximum(a, b)
        flag = (a > b).astype(jnp.int32)
        sk = (flag * _SK_FLAG
              + (irk_q.astype(jnp.int64) * max_nc + nx).astype(jnp.int32))
        pk = jnp.where(keep, pk, jnp.int64(BIG))
        sk = jnp.where(keep, sk, _SK_BIG)
        # lexicographic (pair, first-encounter) sort: group firsts ARE the
        # per-pair minima
        pk_s, sk_s = jax.lax.sort((pk, sk), num_keys=2)
        first = jnp.concatenate(
            [jnp.ones(1, bool), pk_s[1:] != pk_s[:-1]])
        first &= pk_s != jnp.int64(BIG)
        cnt = jnp.sum(first)
        pk_u, sk_u = _scatter_compact(jnp, pk_s, sk_s, first, T)
        return pk_u, sk_u, cnt

    return fn


@functools.lru_cache(maxsize=None)
def _merge_fn(sizes: tuple):
    """Merge pk-sorted arrays of the given lengths (the accumulator first,
    then slice parts) into one deduped pk-sorted array; callers drop their
    input references right after the call so the previous accumulator and
    drained parts free as soon as the computation consumes them."""
    import jax
    import jax.numpy as jnp

    k = len(sizes)
    N = sum(sizes)

    # no donate: outputs (N = sum sizes) cannot alias the smaller inputs
    @jax.jit
    def fn(*arrs):
        pk = jnp.concatenate([arrs[2 * i] for i in range(k)])
        sk = jnp.concatenate([arrs[2 * i + 1] for i in range(k)])
        pk_s, sk_s = jax.lax.sort((pk, sk), num_keys=2)
        first = jnp.concatenate(
            [jnp.ones(1, bool), pk_s[1:] != pk_s[:-1]])
        first &= pk_s != jnp.int64(BIG)
        cnt = jnp.sum(first)
        pk_u, sk_u = _scatter_compact(jnp, pk_s, sk_s, first, N)
        return pk_u, sk_u, cnt

    return fn


def _split_pair(jnp, pk, sk, R):
    """(a=query read, b=other read, rest) from the 12-byte pair state."""
    p_lo = pk // R
    p_hi = pk % R
    flag = sk // _SK_FLAG
    rest = sk - flag * _SK_FLAG
    a = jnp.where(flag == 1, p_hi, p_lo)
    b = jnp.where(flag == 1, p_lo, p_hi)
    return a, b, rest


@functools.lru_cache(maxsize=None)
def _gate_fn(N: int):
    """Both reads derive from the 12-byte pair state, so only
    (gate, border, n_border) come back — every extra N-sized operand here
    costs HBM at 250M+ pairs."""
    import jax.numpy as jnp

    @_jit()
    def fn(pk, sk, qlen2, naln, R, t_q, t_n):
        valid = pk != jnp.int64(BIG)
        a, b, _ = _split_pair(jnp, pk, sk, R)
        eq = jnp.clip(a, 0, R - 1).astype(jnp.int32)
        eo = jnp.clip(b, 0, R - 1).astype(jnp.int32)
        q1 = qlen2[eq]
        q2 = qlen2[eo]
        r_q = jnp.minimum(q1, q2) / jnp.maximum(jnp.maximum(q1, q2),
                                                jnp.float32(1e-12))
        n1 = naln[eq]
        n2 = naln[eo]
        r_n = jnp.minimum(n1, n2) / jnp.maximum(n1, n2)
        eps = jnp.float32(_GATE_EPS)
        sure_pass = (r_q >= t_q + eps) | (r_n >= t_n + eps)
        sure_fail = (r_q <= t_q - eps) & (r_n <= t_n - eps)
        border = valid & ~sure_pass & ~sure_fail
        gate = valid & sure_pass
        n_border = jnp.sum(border)
        return gate, border, n_border

    return fn


@functools.lru_cache(maxsize=None)
def _gate_compact_fn(N: int):
    """Spill path: turn a bucket's gated pair state into compacted
    (traversal key, other read) columns.  pk/sk are DONATED (tv aliases
    pk's int64 buffer)."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def fn(pk, sk, gate, R, trav_scale):
        a, b, rest = _split_pair(jnp, pk, sk, R)
        tv = a * trav_scale + rest.astype(jnp.int64)
        eo = jnp.clip(b, 0, R - 1).astype(jnp.int32)
        # mask + sort compaction instead of a scatter.  Output lands
        # tv-SORTED, which every consumer either requires or
        # re-establishes.
        tv_m = jnp.where(gate, tv, jnp.int64(BIG))
        tv_c, eo_c = jax.lax.sort((tv_m, eo), num_keys=1)
        cnt = jnp.sum(gate)
        return tv_c, eo_c, cnt

    return fn


@functools.lru_cache(maxsize=None)
def _border_index_fn(N: int):
    import jax.numpy as jnp

    @_jit()
    def fn(border, pk, sk, R):
        import jax
        a, b, _ = _split_pair(jnp, pk, sk, R)
        # mask + sort compaction (ascending original index, exactly what
        # the former scatter produced, at sort cost instead of scatter)
        iota = jnp.arange(N, dtype=jnp.int32)
        key = jnp.where(border, iota, jnp.int32(N))
        key_s, eq_s, eo_s = jax.lax.sort(
            (key, a.astype(jnp.int32), b.astype(jnp.int32)), num_keys=1)
        idx_s = jnp.where(key_s < N, key_s, 0)
        return idx_s, eq_s, eo_s

    return fn


@functools.lru_cache(maxsize=None)
def _order_fn(N: int, R: int):
    """Sort gated entries into traversal order.  The traversal key
    rebuilds from the pair state; only (key, eo) are sort operands,
    keeping peak HBM near the floor of input+output buffers."""
    import jax
    import jax.numpy as jnp

    @_jit(donate_argnums=(0, 1, 2))
    def fn(pk, sk, gate, max_itv, max_nc, trav_scale):
        big = jnp.int64(BIG)
        a, b, rest = _split_pair(jnp, pk, sk, R)
        tv = a * trav_scale + rest.astype(jnp.int64)
        key = jnp.where(gate, tv, big)
        eo = jnp.clip(b, 0, R - 1).astype(jnp.int32)
        key_s, eo_s = jax.lax.sort((key, eo), num_keys=1)
        E = jnp.sum(gate)
        eq_s = key_s // trav_scale          # >= R for dropped entries
        ei_s = (key_s // max_nc) % max_itv
        # nxt[i] = first j > i where the (read, interval) run changes
        iota = jnp.arange(N, dtype=jnp.int32)
        flag = jnp.concatenate(
            [jnp.ones(1, bool),
             (eq_s[1:] != eq_s[:-1]) | (ei_s[1:] != ei_s[:-1])])
        m = jnp.where(flag, iota, jnp.int32(N))
        sfx = jax.lax.cummin(m[::-1])[::-1]
        nxt = jnp.concatenate([sfx[1:], jnp.full(1, N, jnp.int32)])
        bounds = jnp.searchsorted(eq_s,
                                  jnp.arange(R + 1, dtype=jnp.int64))
        return key_s, eo_s, nxt, bounds, E

    return fn


@functools.lru_cache(maxsize=None)
def _fetch_fn():
    import jax
    import jax.numpy as jnp

    @_jit()
    def fn(key, eo, nxt, rows, max_itv, max_nc):
        k = jnp.take(key, rows)
        ei = ((k // max_nc) % max_itv).astype(jnp.int32)
        return jnp.stack([ei, jnp.take(eo, rows),
                          jnp.take(nxt, rows)])

    return fn


class EntrySet:
    """Gated, traversal-ordered pair entries, device-resident.

    Stored as (traversal key int64, other-read int32, run-jump int32) —
    the query read and interval rank derive from the key.
    ``bounds[q]:bounds[q+1]`` is query q's entry range.  ``fetch(ranges)``
    gathers (ei, eo, nxt) rows for a batch of [start, stop) ranges in ONE
    transfer."""

    def __init__(self, key_d, eo_d, nxt_d, bounds: np.ndarray, E: int,
                 max_itv: int = 1, max_nc: int = 1):
        self._key, self._eo, self._nxt = key_d, eo_d, nxt_d
        self.bounds = bounds
        self.E = E
        self._mi, self._mn = max_itv, max_nc

    def _gather(self, idx: np.ndarray) -> np.ndarray:
        import jax
        import jax.numpy as jnp
        with jax.enable_x64():
            return np.asarray(_fetch_fn()(
                self._key, self._eo, self._nxt, jnp.asarray(idx),
                jnp.int64(self._mi), jnp.int64(self._mn)))

    def fetch(self, ranges: list[tuple[int, int]]):
        """Returns a list of (ei, eo, nxt) int32 array triples, one per
        requested [start, stop) range; one device gather + one transfer."""
        if not ranges:
            return []
        starts = np.fromiter((s for s, _ in ranges), np.int64,
                             len(ranges))
        lens = np.fromiter((t - s for s, t in ranges), np.int64,
                           len(ranges))
        tot = int(lens.sum())
        offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
        idx = (np.arange(tot, dtype=np.int64)
               + np.repeat(starts - offs, lens))
        packed = self._gather(idx)
        out = []
        off = 0
        for s, t in ranges:
            n = t - s
            out.append((packed[0, off:off + n], packed[1, off:off + n],
                        packed[2, off:off + n]))
            off += n
        return out

    def fetch_all(self):
        packed = self._gather(np.arange(self.E, dtype=np.int64))
        return packed[0], packed[1], packed[2]

    def device_buckets(self):
        """[(key_dev, eo_dev, global_base, n_entries)] for the capwalk
        device replay (ops/capwalk.py)."""
        return [(self._key, self._eo, 0, self.E)]


class HostEntrySet:
    """EntrySet with host-resident arrays (the spill path's result): pair
    sets too large for device residency keep their ordered entries in
    host RAM; the walk
    touches ~1% of entries, for which numpy slicing is free."""

    def __init__(self, ei: np.ndarray, eo: np.ndarray, nxt: np.ndarray,
                 bounds: np.ndarray, E: int):
        self._ei, self._eo, self._nxt = ei, eo, nxt
        self.bounds = bounds
        self.E = E

    def fetch(self, ranges: list[tuple[int, int]]):
        return [(self._ei[s:t], self._eo[s:t], self._nxt[s:t])
                for s, t in ranges]

    def fetch_all(self):
        return self._ei, self._eo, self._nxt


def _apply_gate(jnp, pk_fin, sk_fin, N, ql_d, na_d, R_j, qlen_thresh,
                naln_thresh, qlen2, naln):
    """Banded float32 gate on device + exact float64 host re-check of the
    borderline entries (cluster.py:178-183 is float64 host division)."""
    gate, border, n_border = _gate_fn(N)(
        pk_fin, sk_fin, ql_d, na_d, R_j, jnp.float32(qlen_thresh),
        jnp.float32(naln_thresh))
    nb = int(n_border)
    if nb:
        idx_s, eq_b, eo_b = _border_index_fn(N)(border, pk_fin, sk_fin,
                                                R_j)
        pk_b = np.asarray(jnp.stack(
            [idx_s[:nb].astype(jnp.int64), eq_b[:nb].astype(jnp.int64),
             eo_b[:nb].astype(jnp.int64)]))
        bi, ba, bb = pk_b[0], pk_b[1], pk_b[2]
        q1, q2 = qlen2[ba], qlen2[bb]
        n1, n2 = naln[ba], naln[bb]
        ok = ((np.minimum(q1, q2) / np.maximum(np.maximum(q1, q2), 1e-12))
              >= qlen_thresh) | \
             ((np.minimum(n1, n2) / np.maximum(n1, n2)) >= naln_thresh)
        # border entries are disjoint from sure_pass, so a plain set works
        gate = gate.at[jnp.asarray(bi.astype(np.int32))].set(
            jnp.asarray(ok))
    del border
    return gate


def spill_direct_min() -> int:
    """Encounter count beyond which the sharded in-device build is not
    even attempted: the deduped pair state (16 B for each of about half
    the encounters) would take the device's whole memory limit."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get('bytes_limit', 16 << 30)) // 32


def build_entries(jobs: list[ChromJob], R: int, max_itv: int, max_nc: int,
                  qlen2: np.ndarray, naln: np.ndarray, qlen_thresh: float,
                  naln_thresh: float, slice_cap: int,
                  merge_cap: int = 96 * 1024 * 1024,
                  spill_min_encounters: int = 1 << 27):
    """Full device pipeline: enumerate -> per-pair min -> gate -> order.

    qlen_thresh/naln_thresh are the float64 host values ``1 - qlen_diff``
    and ``1 - n_alignment_diff``; borderline float32 ratios are re-checked
    exactly on host.

    Encounter streams above ``spill_min_encounters`` use the SPILL path:
    pair state is partitioned into pk-range buckets, each bucket deduped
    and gated on device with bounded arrays, and accumulated in host RAM
    (a pair set of hundreds of millions does not fit one device array;
    the thresholds were set for a 16 GB device and have not been
    re-derived for this card).  Both paths produce
    identical entry sets (tests/test_cluster.py).

    The whole build runs under the scoped ``jax.enable_x64()`` context —
    pair and traversal keys genuinely need 64-bit integers (the flag is
    scoped, so the rest of the engine keeps default 32-bit tracing).
    """
    import jax
    total_enc = sum(int(j.ccum[-1]) for j in jobs)
    with jax.enable_x64():
        if total_enc > spill_direct_min():
            # far beyond HBM (the deduped pair set alone would need
            # total_enc/2 * 16 B of device memory): don't burn a doomed
            # sharded attempt + compiles, go straight to the host-spill
            # path (first 10M config-5 run: 7B encounters)
            import sys
            print(f'encounter build: {total_enc} encounters, '
                  f'host-spill path', file=sys.stderr)
            instrument.record_path('encounter_build', 'device, host-spill')
            return _spill_with_retry(jobs, R, max_itv, max_nc, qlen2,
                                     naln, qlen_thresh, naln_thresh,
                                     slice_cap)
        if total_enc > spill_min_encounters:
            # NOTE: the fallback call happens OUTSIDE the except
            # blocks — a live exception pins every frame of its
            # traceback, and those frames reference the failed build's
            # device buffers; retrying inside the handler started with
            # HBM still full and even a scalar upload died (found by the
            # first real 10M config-5 run)
            why = None
            try:
                instrument.record_path('encounter_build', 'device, sharded')
                return _build_entries_sharded(
                    jobs, R, max_itv, max_nc, qlen2, naln, qlen_thresh,
                    naln_thresh, slice_cap)
            except _ShardOverflow as e:
                why = f'overflow ({e})'
            except Exception as e:
                # HBM exhaustion mid-build (e.g. other stages' cached
                # device arrays, or other tenants of a SHARED chip,
                # shrank the headroom): free the partial build and retry
                # on the host-spill path rather than dying — parity with
                # the reference's "never OOMs, just slows down" behavior
                if 'RESOURCE_EXHAUSTED' not in str(e):
                    raise
                why = 'exhausted HBM'
            import gc
            import sys
            print(f'WARNING: sharded encounter build {why}; '
                  f'falling back to host-spill path', file=sys.stderr)
            gc.collect()
            instrument.record_path('encounter_build', 'device, host-spill')
            return _spill_with_retry(jobs, R, max_itv, max_nc,
                                     qlen2, naln, qlen_thresh,
                                     naln_thresh, slice_cap)
        instrument.record_path('encounter_build', 'device, in-memory')
        return _build_entries_x64(jobs, R, max_itv, max_nc, qlen2, naln,
                                  qlen_thresh, naln_thresh, slice_cap,
                                  merge_cap)


def _spill_with_retry(jobs, R, max_itv, max_nc, qlen2, naln, qlen_thresh,
                      naln_thresh, slice_cap):
    """Spill build with a degradation ladder: on HBM exhaustion retry
    with 4x/16x smaller enumeration slices and pk buckets — slower (more
    round trips) but with proportionally smaller device transients, so
    it completes even when most of HBM belongs to someone else."""
    import gc
    import sys
    import time
    for div in (1, 4, 16):
        try:
            return _build_entries_spill(
                jobs, R, max_itv, max_nc, qlen2, naln, qlen_thresh,
                naln_thresh, max(slice_cap // div, 1 << 20),
                phase2_cap=max((1 << 26) // div, 1 << 20))
        except Exception as e:
            # fall through and retry OUTSIDE the handler: the live
            # exception's traceback pins the failed attempt's device
            # buffers (see build_entries)
            if 'RESOURCE_EXHAUSTED' not in str(e) or div == 16:
                raise
        print(f'WARNING: host-spill build exhausted HBM at '
              f'slice_cap/{div}; retrying at slice_cap/{div * 4}',
              file=sys.stderr)
        gc.collect()
        time.sleep(2)       # let async remote deallocation land


def _enum_job_slices(jnp, job, slice_cap, R_j, mn_j):
    """Yield (pk_u, sk_u, cnt_dev, T) per slice of one chrom job (shared
    by the in-HBM and spill paths)."""
    nc = len(job.starts)
    total = int(job.ccum[-1])
    if total == 0:
        return
    NCpad = _bucket(nc, tuple(1 << s for s in range(10, 32)))
    ccum_d = jnp.asarray(np.concatenate(
        [job.ccum, np.full(NCpad - nc, job.ccum[-1], np.int64)]))

    def pad32(a):
        return jnp.asarray(np.concatenate(
            [a.astype(np.int32), np.zeros(NCpad - nc, np.int32)]))

    lo_d, st_d, en_d = pad32(job.lo), pad32(job.starts), pad32(job.ends)
    rid_d, irk_d = pad32(job.rid), pad32(job.irk)
    nc_j = jnp.int64(nc)
    # jobs larger than one slice use the FULL slice bucket for every
    # slice (including the tail): downstream merge shapes then come from
    # a tiny fixed set, each compiled once and reused from the persistent
    # XLA cache — per-merge unique shapes would each pay a compile
    T = _bucket(min(total, slice_cap))
    g0 = 0
    while g0 < total:
        tot_s = min(total - g0, slice_cap)
        pk_u, sk_u, cnt = _enum_reduce_fn(T)(
            ccum_d, lo_d, st_d, en_d, rid_d, irk_d,
            jnp.int64(g0), jnp.int64(tot_s), nc_j, R_j, mn_j)
        yield pk_u, sk_u, cnt, T
        g0 += tot_s


# ---------------------------------------------------------------------------
# Sharded device-resident scale path.
#
# A pair set of hundreds of millions does not fit ONE device array (the
# bucket sizes below were set for a 16 GB device with a 2 GiB
# single-buffer limit and have not been re-derived for this card) — but
# it CAN live in B bucket arrays of <= 2^26 entries each.  This path
# keeps everything on device and moves only search-cut indices to the
# host (the host-spill fallback below moves the whole pair state).
#
#   phase 1: enumerate slices; split each slice's pk-sorted uniques into
#            pk-range buckets with fixed-shape dynamic-slice parts;
#            each bucket merges its parts into a pow2 accumulator
#            (device sorts, donated buffers);
#   phase 2: gate each bucket (banded f32 + host borderline), compact to
#            (traversal key, other read);
#   phase 3: exchange into query-range buckets (traversal order is
#            query-major, so per-bucket sorted entries concatenate into
#            the global traversal order), finalize run-jumps + bounds.

_PART = 1 << 22          # fixed exchange-part shape (4M entries)
_BUCKET_CAP = 1 << 26    # max entries a bucket accumulator may reach


class _ShardOverflow(Exception):
    """A bucket exceeded _BUCKET_CAP (pathological key skew) — the caller
    falls back to the host-spill path."""


@functools.lru_cache(maxsize=None)
def _cuts_fn(T: int, B: int):
    import jax.numpy as jnp

    @_jit()
    def fn(pk_u, bounds_arr):
        return jnp.searchsorted(pk_u, bounds_arr)

    return fn


@functools.lru_cache(maxsize=None)
def _pad_fn(T: int):
    """Pad a (T,) pair state by one part of BIG so every dynamic part
    slice below stays in range (padded once per slice, not per part)."""
    import jax.numpy as jnp

    @_jit()
    def fn(pk_u, sk_u):
        return (jnp.concatenate([pk_u, jnp.full(_PART, BIG, jnp.int64)]),
                jnp.concatenate([sk_u,
                                 jnp.full(_PART, _SK_BIG, jnp.int32)]))

    return fn


@functools.lru_cache(maxsize=None)
def _slice_part_fn(T: int):
    """Extract entries [start, start+n) of a padded (T+_PART,) pair state
    into a fixed (_PART,) shape, BIG-masked beyond n."""
    import jax
    import jax.numpy as jnp

    @_jit()
    def fn(pkp, skp, start, n):
        pk = jax.lax.dynamic_slice(pkp, (start,), (_PART,))
        sk = jax.lax.dynamic_slice(skp, (start,), (_PART,))
        iota = jnp.arange(_PART, dtype=jnp.int32)
        pk = jnp.where(iota < n, pk, jnp.int64(BIG))
        sk = jnp.where(iota < n, sk, _SK_BIG)
        return pk, sk

    return fn


class _DevAcc:
    """Per-bucket device accumulator: fixed-shape parts merge into a
    sorted BIG-tailed array.  Below _TRIM_AT the accumulator stays
    UNTRIMMED: its sizes are then data-independent, so the whole merge
    chain dispatches asynchronously — fetching the count to compact it
    is a host round trip.  ``finalize()`` trims once at the end."""

    KMAX = 4
    TRIM_AT = 1 << 25

    def __init__(self):
        self.parts: list = []       # (pk(_PART,), sk(_PART,))
        self.acc = None             # (pk(NA,), sk(NA,))
        self.cnt = None             # known only after a trim

    def add(self, pk, sk):
        self.parts.append((pk, sk))
        if len(self.parts) >= self.KMAX:
            self.merge()

    def merge(self):
        while self.parts:
            group = [self.parts.pop(0)
                     for _ in range(min(self.KMAX, len(self.parts)))]
            arrs: list = []
            sizes: list = []
            if self.acc is not None:
                arrs += [self.acc[0], self.acc[1]]
                sizes.append(int(self.acc[0].shape[0]))
            for pk, sk in group:
                arrs += [pk, sk]
                sizes.append(int(pk.shape[0]))
            pk_m, sk_m, cnt = _merge_fn(tuple(sizes))(*arrs)
            N = sum(sizes)
            if N >= self.TRIM_AT:
                c = int(cnt)        # sync: compact large accumulators
                if c > _BUCKET_CAP:
                    raise _ShardOverflow(c)
                Np = _bucket(max(c, 1))
                if Np < N:
                    pk_m, sk_m = pk_m[:Np], sk_m[:Np]
                self.cnt = c
            else:
                self.cnt = None     # unknown; chain stays async
            self.acc = (pk_m, sk_m)

    def finalize(self) -> int:
        """Drain parts and return the exact unique count (one sync).
        The accumulator is already deduped+compacted by merge(); only
        the count (and a trim) may be outstanding."""
        self.merge()
        if self.acc is None:
            self.cnt = 0
        elif self.cnt is None:
            N = int(self.acc[0].shape[0])
            c = int(_count_fn(N)(self.acc[0]))
            if c > _BUCKET_CAP:
                raise _ShardOverflow(c)
            Np = _bucket(max(c, 1))
            if Np < N:
                self.acc = (self.acc[0][:Np], self.acc[1][:Np])
            self.cnt = c
        return self.cnt


@functools.lru_cache(maxsize=None)
def _count_fn(N: int):
    import jax.numpy as jnp

    @_jit()
    def fn(pk):
        return jnp.sum(pk != jnp.int64(BIG))

    return fn


@functools.lru_cache(maxsize=None)
def _sort_tv_fn(N: int):
    import jax

    @_jit(donate_argnums=(0, 1))
    def fn(tv, eo):
        return jax.lax.sort((tv, eo), num_keys=2)

    return fn


class ShardedEntrySet:
    """Traversal-ordered entries held as per-query-range device buckets.

    The global entry index space is the concatenation of the buckets;
    one query's entries always live inside one bucket, so every fetch
    range maps to exactly one bucket."""

    def __init__(self, buckets, offsets: np.ndarray, bounds: np.ndarray,
                 E: int, max_itv: int, max_nc: int):
        # buckets: list of (key_d, eo_d, nxt_local_d) or None
        self._buckets = buckets
        self._offsets = offsets      # (len(buckets)+1,) global entry base
        self.bounds = bounds
        self.E = E
        self._mi, self._mn = max_itv, max_nc

    def _bucket_of(self, s: int) -> int:
        return int(np.searchsorted(self._offsets, s, side='right') - 1)

    def device_buckets(self):
        """[(key_dev, eo_dev, global_base, n_entries)] per bucket, in
        global traversal order (queries never span buckets)."""
        out = []
        for bi, b in enumerate(self._buckets):
            if b is None:
                continue
            key_d, eo_d, _ = b
            base = int(self._offsets[bi])
            out.append((key_d, eo_d, base,
                        int(self._offsets[bi + 1]) - base))
        return out

    def fetch(self, ranges: list[tuple[int, int]]):
        if not ranges:
            return []
        import jax
        import jax.numpy as jnp
        by_bucket: dict[int, list[int]] = {}
        for ri, (s, t) in enumerate(ranges):
            by_bucket.setdefault(self._bucket_of(s), []).append(ri)
        out: list = [None] * len(ranges)
        for bi, ris in by_bucket.items():
            key_d, eo_d, nxt_d = self._buckets[bi]
            base = int(self._offsets[bi])
            starts = np.fromiter((ranges[r][0] - base for r in ris),
                                 np.int64, len(ris))
            lens = np.fromiter((ranges[r][1] - ranges[r][0] for r in ris),
                               np.int64, len(ris))
            tot = int(lens.sum())
            offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
            idx = (np.arange(tot, dtype=np.int64)
                   + np.repeat(starts - offs, lens))
            with jax.enable_x64():
                packed = np.asarray(_fetch_fn()(
                    key_d, eo_d, nxt_d, jnp.asarray(idx),
                    jnp.int64(self._mi), jnp.int64(self._mn)))
            off = 0
            for r in ris:
                n = ranges[r][1] - ranges[r][0]
                # bucket-local jumps are small; the global rebase must be
                # 64-bit once offsets pass 2^31
                nxt_g = packed[2, off:off + n].astype(np.int64) + base
                out[r] = (packed[0, off:off + n],
                          packed[1, off:off + n], nxt_g)
                off += n
        return out

    def fetch_all(self):
        triples = self.fetch([(int(self._offsets[i]),
                               int(self._offsets[i]) + self._sizes[i])
                              for i in range(len(self._buckets))
                              if self._buckets[i] is not None])
        ei = np.concatenate([t[0] for t in triples]) if triples else \
            np.zeros(0, np.int32)
        eo = np.concatenate([t[1] for t in triples]) if triples else \
            np.zeros(0, np.int32)
        nx = np.concatenate([t[2] for t in triples]) if triples else \
            np.zeros(0, np.int32)
        return ei, eo, nx


def _build_entries_sharded(jobs, R, max_itv, max_nc, qlen2, naln,
                           qlen_thresh, naln_thresh, slice_cap):
    """Device-resident bucketed build (raises _ShardOverflow on extreme
    key skew; the caller falls back to the host-spill path)."""
    import os
    import sys
    import time

    import jax.numpy as jnp

    dbg = bool(os.environ.get('FSLR_ENC_DEBUG'))
    t_start = time.time()

    def _dbg(msg):
        if dbg:
            print(f'[enc-shard] +{time.time() - t_start:6.2f}s {msg}',
                  file=sys.stderr)

    trav_scale = max_itv * max_nc
    assert trav_scale * (R + 1) < (1 << 62), 'traversal key overflow'
    assert trav_scale < _SK_FLAG, \
        'interval-rank state exceeds 2^30 (caller must use the host path)'
    R_j = jnp.int64(R)
    mn_j = jnp.int64(max_nc)

    total_enc = sum(int(j.ccum[-1]) for j in jobs)
    # pk-range buckets: target <= 2^24 unique entries per bucket so the
    # accumulator sorts stay small; encounters overcount uniques ~2x
    B = 1
    while B < 4096 and total_enc // B > (1 << 25):
        B *= 2
    W = (R * R) // B + 1
    pk_bounds = jnp.asarray(np.arange(1, B, dtype=np.int64) * W)
    accs = [_DevAcc() for _ in range(B)]

    # ---- phase 1: enumerate + device split into pk buckets -------------
    for job in jobs:
        for pk_u, sk_u, cnt, T in _enum_job_slices(jnp, job, slice_cap,
                                                   R_j, mn_j):
            c = int(cnt)
            if c == 0:
                continue
            if B == 1:
                cuts = np.array([0, c], np.int64)
            else:
                cuts = np.concatenate(
                    [[0], np.asarray(_cuts_fn(T, B)(pk_u, pk_bounds)),
                     [c]])
                cuts = np.minimum(cuts, c)
            pkp, skp = _pad_fn(T)(pk_u, sk_u)
            for b in range(B):
                lo, hi = int(cuts[b]), int(cuts[b + 1])
                off = lo
                while off < hi:
                    n = min(hi - off, _PART)
                    pk_p, sk_p = _slice_part_fn(T)(
                        pkp, skp, jnp.int64(off), jnp.int32(n))
                    accs[b].add(pk_p, sk_p)
                    off += n
            del pkp, skp
    U = sum(a.finalize() for a in accs)
    _dbg(f'phase 1: {B} pk-buckets merged (U={U})')
    if U == 0:
        z = np.zeros(0, np.int32)
        return HostEntrySet(z, z, z, np.zeros(R + 1, np.int64), 0)

    # ---- phase 2: gate + compact to (tv, eo) per pk bucket -------------
    ql_d = jnp.asarray(qlen2.astype(np.float32))
    na_d = jnp.asarray(naln.astype(np.float32))
    tv_buckets: list = []       # (tv_c, eo_c, count) unsorted-in-tv
    for a in accs:
        if a.cnt == 0:
            a.acc = None
            continue
        N = int(a.acc[0].shape[0])
        gate = _apply_gate(jnp, a.acc[0], a.acc[1], N, ql_d, na_d, R_j,
                           qlen_thresh, naln_thresh, qlen2, naln)
        tv_c, eo_c, cnt_g = _gate_compact_fn(N)(
            a.acc[0], a.acc[1], gate, R_j, jnp.int64(trav_scale))
        a.acc = None
        g = int(cnt_g)
        if g:
            tv_buckets.append((tv_c, eo_c, g))
    del accs
    _dbg('phase 2: gated + compacted')

    # ---- phase 3: exchange into query-range buckets, order, finalize --
    E = sum(g for (_, _, g) in tv_buckets)
    if E == 0:
        z = np.zeros(0, np.int32)
        return HostEntrySet(z, z, z, np.zeros(R + 1, np.int64), 0)
    B2 = 1
    while B2 < 4096 and E // B2 > (1 << 25):
        B2 *= 2
    qw = (R + B2) // B2            # query ids per ordering bucket
    tv_bounds = jnp.asarray(
        np.arange(1, B2, dtype=np.int64) * qw * trav_scale)
    oaccs = [_DevAcc() for _ in range(B2)]
    for tv_c, eo_c, g in tv_buckets:
        N = int(tv_c.shape[0])
        tv_s, eo_s = _sort_tv_fn(N)(tv_c, eo_c)
        if B2 == 1:
            cuts = np.array([0, g], np.int64)
        else:
            cuts = np.concatenate(
                [[0], np.asarray(_cuts_fn(N, B2)(tv_s, tv_bounds)), [g]])
            cuts = np.minimum(cuts, g)
        tvp, eop = _pad_fn(N)(tv_s, eo_s)
        for b in range(B2):
            lo, hi = int(cuts[b]), int(cuts[b + 1])
            off = lo
            while off < hi:
                n = min(hi - off, _PART)
                tv_p, eo_p = _slice_part_fn(N)(
                    tvp, eop, jnp.int64(off), jnp.int32(n))
                oaccs[b].add(tv_p, eo_p)
                off += n
        del tvp, eop
    tv_buckets.clear()
    _dbg(f'phase 3: exchanged into {B2} query-buckets')

    buckets: list = []
    offsets = np.zeros(B2 + 1, np.int64)
    bounds = np.zeros(R + 1, np.int64)
    sizes = []
    base = 0
    for j, a in enumerate(oaccs):
        a.finalize()
        offsets[j] = base
        if a.cnt == 0:
            buckets.append(None)
            sizes.append(0)
            continue
        key_d, eo_d = a.acc
        a.acc = None
        N = int(key_d.shape[0])
        nxt_d, bounds_local = _order_local_fn(N, R)(
            key_d, jnp.int64(max_itv), jnp.int64(max_nc),
            jnp.int64(trav_scale))
        q_lo = j * qw
        q_hi = min((j + 1) * qw, R + 1)
        bl = np.asarray(bounds_local)
        bounds[q_lo:q_hi] = base + bl[q_lo:q_hi]
        buckets.append((key_d, eo_d, nxt_d))
        sizes.append(a.cnt)
        base += a.cnt
    offsets[B2] = base
    bounds[-1] = base
    # queries past the last populated bucket keep monotone bounds
    np.maximum.accumulate(bounds, out=bounds)
    _dbg(f'phase 3: finalized (E={base})')
    es = ShardedEntrySet(buckets, offsets, bounds, base, max_itv, max_nc)
    es._sizes = sizes
    return es


@functools.lru_cache(maxsize=None)
def _order_local_fn(N: int, R: int):
    """Run-jump + per-query bounds for one tv-sorted ordering bucket.
    key has BIG beyond the real entries, so eq >= R there and
    searchsorted keeps them past every query."""
    import jax
    import jax.numpy as jnp

    @_jit()
    def fn(key, max_itv, max_nc, trav_scale):
        eq_s = key // trav_scale
        ei_s = (key // max_nc) % max_itv
        iota = jnp.arange(N, dtype=jnp.int32)
        flag = jnp.concatenate(
            [jnp.ones(1, bool),
             (eq_s[1:] != eq_s[:-1]) | (ei_s[1:] != ei_s[:-1])])
        m = jnp.where(flag, iota, jnp.int32(N))
        sfx = jax.lax.cummin(m[::-1])[::-1]
        nxt = jnp.concatenate([sfx[1:], jnp.full(1, N, jnp.int32)])
        bounds = jnp.searchsorted(eq_s,
                                  jnp.arange(R + 1, dtype=jnp.int64))
        return nxt, bounds

    return fn


def _build_entries_spill(jobs, R, max_itv, max_nc, qlen2, naln,
                         qlen_thresh, naln_thresh, slice_cap,
                         phase2_cap=1 << 26) -> 'HostEntrySet':
    """Out-of-HBM build: device enumerate/dedup/gate over pk-range
    buckets, host-RAM accumulation, host traversal sort.  Capacity is
    bounded by host RAM (billions of pairs), not by HBM."""
    import os
    import sys
    import time

    import jax.numpy as jnp

    dbg = bool(os.environ.get('FSLR_ENC_DEBUG'))
    t_start = time.time()

    def _dbg(msg):
        if dbg:
            print(f'[enc-spill] +{time.time() - t_start:6.2f}s {msg}',
                  file=sys.stderr)

    trav_scale = max_itv * max_nc
    assert trav_scale * (R + 1) < (1 << 62), 'traversal key overflow'
    assert trav_scale < _SK_FLAG, \
        'interval-rank state exceeds 2^30 (caller must use the host path)'
    R_j = jnp.int64(R)
    mn_j = jnp.int64(max_nc)

    total_enc = sum(int(j.ccum[-1]) for j in jobs)
    # pk-range bucket size: set for a 16 GB device, not re-derived for
    # this card
    B = 1
    while B < 4096 and total_enc // B > phase2_cap:
        B *= 2
    W = (R * R) // B + 1
    bucket_bounds = np.arange(1, B, dtype=np.int64) * W
    host_pk: list[list] = [[] for _ in range(B)]
    host_sk: list[list] = [[] for _ in range(B)]

    # ---- phase 1: enumerate slices, spill per-bucket to host ----------
    for job in jobs:
        for pk_u, sk_u, cnt, T in _enum_job_slices(jnp, job, slice_cap,
                                                   R_j, mn_j):
            c = int(cnt)
            if c == 0:
                continue
            pk_h = np.asarray(pk_u[:c])
            sk_h = np.asarray(sk_u[:c])
            cuts = np.concatenate(
                [[0], np.searchsorted(pk_h, bucket_bounds), [c]])
            for b in range(B):
                if cuts[b + 1] > cuts[b]:
                    host_pk[b].append(pk_h[cuts[b]:cuts[b + 1]])
                    host_sk[b].append(sk_h[cuts[b]:cuts[b + 1]])
    _dbg(f'slices spilled to {B} host buckets '
         f'({sum(len(p) for ps in host_pk for p in ps)} entries)')

    # ---- phase 2: per bucket, HOST dedup + exact float64 gate ---------
    # A device roundtrip (re-upload every bucket, merge/gate kernels,
    # gated fetch) would move the whole pair state a second and third
    # time.  Host dedup is ONE stable argsort + minimum.reduceat per
    # bucket (phase-1 slices arrive pk-sorted, so the mergesort is
    # near-linear), and the float64 gate below IS the reference's host
    # arithmetic (cluster.py:178-183) — the device gate + borderline
    # re-check construction exists precisely to equal it.
    qlen2_f = qlen2.astype(np.float64)
    naln_f = naln.astype(np.float64)
    # gated entries land in QUERY-RANGE buckets so the traversal sort
    # (phase 3) runs one bounded range at a time — a single global
    # argsort of billions of tv keys needs ~3x the entry bytes in
    # transients and topped host RAM at config-5 scale
    NQR = 64
    q_span = max(1, -(-R // NQR))
    range_tv: list[list] = [[] for _ in range(NQR)]
    range_eo: list[list] = [[] for _ in range(NQR)]
    for b in range(B):
        if not host_pk[b]:
            continue
        pk_all = np.concatenate(host_pk[b])
        sk_all = np.concatenate(host_sk[b])
        host_pk[b] = host_sk[b] = None
        ord_ = np.argsort(pk_all, kind='stable')
        pk_s = pk_all[ord_]
        del pk_all
        starts_r = np.flatnonzero(np.concatenate(
            [[True], pk_s[1:] != pk_s[:-1]]))
        pk_u = pk_s[starts_r]
        sk_u = np.minimum.reduceat(sk_all[ord_], starts_r)
        del pk_s, sk_all, ord_, starts_r
        flag = (sk_u // _SK_FLAG).astype(np.int64)
        rest = (sk_u - flag * _SK_FLAG).astype(np.int64)
        p_lo = pk_u // R
        p_hi = pk_u % R
        del pk_u, sk_u
        a = np.where(flag == 1, p_hi, p_lo)
        bb = np.where(flag == 1, p_lo, p_hi)
        del p_lo, p_hi, flag
        q1 = qlen2_f[a]
        q2 = qlen2_f[bb]
        n1 = naln_f[a]
        n2 = naln_f[bb]
        ok = ((np.minimum(q1, q2)
               / np.maximum(np.maximum(q1, q2), 1e-12)) >= qlen_thresh) \
            | ((np.minimum(n1, n2) / np.maximum(n1, n2)) >= naln_thresh)
        del q1, q2, n1, n2
        if ok.any():
            a_k = a[ok]
            tv_k = a_k * trav_scale + rest[ok]
            eo_k = bb[ok].astype(np.int32)
            qr_k = (a_k // q_span).astype(np.int64)
            del a_k
            ord_q = np.argsort(qr_k, kind='stable')
            qr_s = qr_k[ord_q]
            cuts = np.searchsorted(qr_s, np.arange(NQR + 1))
            tv_s = tv_k[ord_q]
            eo_s_ = eo_k[ord_q]
            del tv_k, eo_k, qr_k, qr_s, ord_q
            for qr in range(NQR):
                if cuts[qr + 1] > cuts[qr]:
                    range_tv[qr].append(tv_s[cuts[qr]:cuts[qr + 1]])
                    range_eo[qr].append(eo_s_[cuts[qr]:cuts[qr + 1]])
            del tv_s, eo_s_
        del a, bb, rest, ok
    _dbg('buckets deduped + gated')

    # ---- phase 3: per-query-range traversal order + bounds ------------
    # (the former run-jump array `nxt` fed the DEVICE walk only; the
    # spill path's consumer is the chunked host replay, so building it
    # was 8 B/entry of dead allocation)
    counts_q = np.zeros(R, np.int64)
    ei_parts: list[np.ndarray] = []
    eo_parts2: list[np.ndarray] = []
    E = 0
    for qr in range(NQR):
        if not range_tv[qr]:
            continue
        tv = np.concatenate(range_tv[qr])
        eo_r = np.concatenate(range_eo[qr])
        range_tv[qr] = range_eo[qr] = None
        order = np.argsort(tv, kind='stable')    # radix; tv is unique
        tv = tv[order]
        eo_r = eo_r[order]
        del order
        eq_r = tv // trav_scale
        q_lo = qr * q_span
        hi_q = min(q_lo + q_span, R)        # last range is shorter when
        w = hi_q - q_lo                     # R % q_span != 0
        counts_q[q_lo:hi_q] += np.bincount(eq_r - q_lo,
                                           minlength=w)[:w]
        ei_parts.append(((tv // max_nc) % max_itv).astype(np.int32))
        del tv, eq_r
        eo_parts2.append(eo_r)
        E += len(eo_r)
    if E == 0:
        z = np.zeros(0, np.int32)
        return HostEntrySet(z, z, None, np.zeros(R + 1, np.int64), 0)
    ei_s = np.concatenate(ei_parts)
    del ei_parts
    eo_s = np.concatenate(eo_parts2)
    del eo_parts2
    bounds = np.zeros(R + 1, np.int64)
    np.cumsum(counts_q, out=bounds[1:])
    _dbg(f'host order done (E={E})')
    return HostEntrySet(ei_s, eo_s, None, bounds, E)


def _build_entries_x64(jobs, R, max_itv, max_nc, qlen2, naln, qlen_thresh,
                       naln_thresh, slice_cap, merge_cap) -> EntrySet:
    import os
    import sys
    import time

    import jax.numpy as jnp

    dbg = bool(os.environ.get('FSLR_ENC_DEBUG'))
    t_start = time.time()

    def _dbg(msg):
        if dbg:
            print(f'[enc] +{time.time() - t_start:6.2f}s {msg}',
                  file=sys.stderr)

    trav_scale = max_itv * max_nc
    assert trav_scale * (R + 1) < (1 << 62), 'traversal key overflow'
    assert trav_scale < _SK_FLAG, \
        'interval-rank state exceeds 2^30 (caller must use the host path)'

    R_j = jnp.int64(R)
    mn_j = jnp.int64(max_nc)

    # ---- phase 1: per-slice enumerate + reduce -------------------------
    # Slice uniques merge INCREMENTALLY into one deduped pow2-compacted
    # accumulator through donated merge calls (at most KMAX parts per
    # merge), so the peak device footprint is accumulator + one merge's
    # inputs/outputs — there is no giant end-of-phase force-merge.
    KMAX = 3
    parts: list[tuple] = []      # (pk_dev(T,), sk_dev(T,), cnt_dev)
    held = 0
    acc: tuple | None = None     # (pk_dev(NA,), sk_dev(NA,)) BIG-tailed
    acc_cnt = 0

    def merge_parts():
        nonlocal held, acc, acc_cnt
        while parts:
            group = [parts.pop(0) for _ in range(min(KMAX, len(parts)))]
            arrs = []
            sizes = []
            if acc is not None:
                arrs += [acc[0], acc[1]]
                sizes.append(int(acc[0].shape[0]))
            for (pk_u, sk_u, _) in group:
                arrs += [pk_u, sk_u]
                sizes.append(int(pk_u.shape[0]))
            if len(sizes) == 1:
                # single already-deduped part becomes the accumulator
                pk_m, sk_m, cnt = group[0]
            else:
                pk_m, sk_m, cnt = _merge_fn(tuple(sizes))(*arrs)
            c = int(cnt)
            Np = _bucket(max(c, 1))
            if Np < int(pk_m.shape[0]):
                pk_m, sk_m = pk_m[:Np], sk_m[:Np]
            acc = (pk_m, sk_m)
            acc_cnt = c
        held = 0

    for job in jobs:
        for pk_u, sk_u, cnt, T in _enum_job_slices(jnp, job, slice_cap,
                                                   R_j, mn_j):
            parts.append((pk_u, sk_u, cnt))
            held += T
            if held >= merge_cap or len(parts) >= KMAX:
                merge_parts()
    merge_parts()
    _dbg(f'slices enumerated + merged (U={acc_cnt})')

    if acc is None or acc_cnt == 0:
        return EntrySet(None, None, None, np.zeros(R + 1, np.int64), 0)
    pk_fin, sk_fin = acc
    acc = None
    N = int(pk_fin.shape[0])
    U = acc_cnt

    # ---- phase 2: gate (banded f32 + exact host borderline) ------------
    ql_d = jnp.asarray(qlen2.astype(np.float32))
    na_d = jnp.asarray(naln.astype(np.float32))
    gate = _apply_gate(jnp, pk_fin, sk_fin, N, ql_d, na_d, R_j,
                       qlen_thresh, naln_thresh, qlen2, naln)
    _dbg('gate done')

    # ---- phase 3: traversal order + run-jump + bounds -------------------
    key_s, eo_s, nxt, bounds_d, E = _order_fn(N, R)(
        pk_fin, sk_fin, gate, jnp.int64(max_itv), jnp.int64(max_nc),
        jnp.int64(trav_scale))
    del pk_fin, sk_fin, gate
    bounds = np.asarray(bounds_d).astype(np.int64)
    E = int(E)
    # trim the non-gated tail (pow2-bucketed) to release device memory
    Ek = _bucket(max(E, 1))
    if Ek < N:
        key_s, eo_s, nxt = key_s[:Ek], eo_s[:Ek], nxt[:Ek]
    _dbg(f'order done (E={E})')
    return EntrySet(key_s, eo_s, nxt, bounds, E, max_itv, max_nc)
