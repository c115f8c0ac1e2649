"""Breakpoint clustering: the reference cluster.py + main.py:190-352 block.

Replicated semantics (citations into /root/reference/fslr/):

  * rename_chromosomes (cluster.py:34-43): numeric chromosome ids sorted by
    the chrN-numeric key.  The reference sorts a *set* (process-dependent
    tie order for non-chrN names); we fix the deterministic tie-break
    (numeric key, name).
  * delete_false (cluster.py:80-86): drop qnames containing 'False'.
  * keep_fillings (cluster.py:14-31): drop each read's first & last
    alignment rows ("bread"), qlen2 = interior span.
  * filter_high_coverage (cluster.py:52-77): numpy diff-array coverage,
    drop intervals whose midpoint coverage > 10000.
  * prepare_data (cluster.py:109-121): start/end normalization, middle,
    stable sort by start, subtelomere/chromosome masking (cluster.py:89-106;
    the reference's final "reduced to 1 interval" branch compares the
    *whole dataset* length and is unreachable — we mirror the loop only).
  * query_interval_trees (cluster.py:187-227): per-chrom interval search
    (sorted starts + prefix-max ends instead of superintervals; results in
    ascending-start order), pair dedup via seen_edges, qlen2/n_alignments
    gate (cluster.py:178-183), greedy Jaccard (ops/jaccard.py) with
    per-intersection-count thresholds and the soft edge cap of 10
    (main.py:221, cluster.py:223-224).  Pair similarities are computed in
    one batched device call over the (cap-unaware) superset of candidate
    pairs — every pair the reference traversal tests is in the superset and
    its Jaccard value does not depend on where it is tested — then the
    reference loop (including the cap's break behavior) is replayed exactly.
  * connected components (cluster.py:230-234) via ops/components.py, with
    cluster ordering = first-seen node order, matching
    networkx.connected_components iteration.
  * main.py:207-352 post-processing: melt to (cluster, qname, n_reads),
    early exit when the graph has no edges ("No clusters were found."),
    merge onto the bed, singleton cluster ids, chrom restore, and
    choose_alignment representatives (cluster.py:237-254).
"""

from __future__ import annotations

import dataclasses
import sys
from collections import namedtuple

import numpy as np

from fslr_tpu import instrument
from fslr_tpu.config import ClusterConfig
from fslr_tpu.ops import capwalk, components, jaccard
from fslr_tpu.table import Table

# max encounters materialized per enumeration slice (see query_graph)
ENCOUNTER_SLICE_CAP = 32 * 1024 * 1024

IntervalItem = namedtuple(
    'IntervalItem',
    ['chrom', 'start', 'end', 'aln_size', 'qname', 'n_alignments', 'qlen2',
     'middle', 'index'])


def rename_chromosomes(bed_file, chromosome_lengths, chromosome_mask):
    def sort_key(x):
        num = (int(x[3:]) if x[:3] == 'chr' and x[3:].isdigit()
               else float('inf'))
        return (num, x)
    bed_file = Table.of(bed_file).copy()
    chromosome_names = sorted(set(bed_file['chrom'].tolist()), key=sort_key)
    cmap = {name: i + 1 for i, name in enumerate(chromosome_names)}
    chr_lengths = {cmap.get(k): v for k, v in chromosome_lengths.items()}
    bed_file['chrom'] = np.array([cmap[x] for x in bed_file['chrom'].tolist()],
                                 np.int64)
    chromosome_mask = [cmap.get(x) if x != 'subtelomere' else x
                       for x in chromosome_mask]
    return bed_file, chr_lengths, chromosome_mask, cmap


def chrom_to_str(bed_df, cmap):
    num_to_str = {v: k for k, v in cmap.items()}
    bed_df = bed_df.copy()
    bed_df['chrom'] = np.array(
        [num_to_str[x] for x in bed_df['chrom'].tolist()], object)
    return bed_df


def delete_false(bed_file):
    bed_file = Table.of(bed_file)
    return bed_file.take(np.array(
        ['False' not in q for q in bed_file['qname'].tolist()], bool))


def _group_codes(keys: np.ndarray):
    """(codes, n_groups) with codes[i] the group of row i."""
    _, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(-1)
    return inv, (int(inv.max()) + 1 if len(inv) else 0)


def keep_fillings(bed_file):
    """Drop each read's first and last row (the primer 'bread'), keep the
    rows in between, and add qlen2 = max(qend) - min(qstart) per read."""
    bed_file = Table.of(bed_file)
    codes, n = _group_codes(bed_file['qname'])
    rows = np.arange(len(codes))
    first = np.full(n, len(codes))
    np.minimum.at(first, codes, rows)
    last = np.full(n, -1)
    np.maximum.at(last, codes, rows)
    filling = (first[codes] != rows) & (last[codes] != rows)
    bed_file = bed_file.take(filling)
    codes, n = _group_codes(bed_file['qname'])
    qe = bed_file['qend']
    qs = bed_file['qstart']
    hi = np.full(n, np.iinfo(np.int64).min, qe.dtype) \
        if qe.dtype.kind in 'iu' else np.full(n, -np.inf)
    np.maximum.at(hi, codes, qe)
    lo = np.full(n, np.iinfo(np.int64).max, qs.dtype) \
        if qs.dtype.kind in 'iu' else np.full(n, np.inf)
    np.minimum.at(lo, codes, qs)
    bed_file['qlen2'] = hi[codes] - lo[codes]
    return bed_file


def calc_coverage(bed_file, chromosome_lengths):
    coverage = {}
    chroms = bed_file['chrom']
    for chrom in np.unique(chroms).tolist():
        if chrom not in chromosome_lengths:
            continue
        sel = chroms == chrom
        c = np.zeros(chromosome_lengths[chrom] + 1)
        np.add.at(c, bed_file['rstart'][sel], 1)
        np.add.at(c, bed_file['rend'][sel], -1)
        coverage[chrom] = np.cumsum(c)
    return coverage


def filter_high_coverage(data, bed_file, chromosome_lengths, threshold):
    cov = calc_coverage(bed_file, chromosome_lengths)
    return [a for a in data if cov[a.chrom][a.middle] <= threshold]


def mask_sequences(data, mask, chromosome_lengths, threshold=500_000):
    if not mask:
        return data
    chromosome_lengths = {k: v for k, v in chromosome_lengths.items()
                          if v > 1_000_000}
    out = []
    for a in data:
        if a.chrom in mask:
            continue
        if 'subtelomere' in mask:
            if a.chrom in chromosome_lengths and \
                    (a.start < threshold
                     or chromosome_lengths[a.chrom] - a.end < threshold):
                continue
        out.append(a)
    return out


def prepare_data(bed_df, cluster_mask, chromosome_lengths,
                 threshold=500_000):
    bed_df = Table.of(bed_df).copy()
    bed_df['start'] = np.minimum(bed_df['rstart'], bed_df['rend'])
    bed_df['end'] = np.maximum(bed_df['rstart'], bed_df['rend'])
    bed_df['middle'] = bed_df['aln_size'] // 2 + bed_df['start']
    bed_df = bed_df.sort(['start'])
    columns = ['chrom', 'start', 'end', 'aln_size', 'qname', 'n_alignments',
               'qlen2', 'middle']
    data = [IntervalItem(*vals) for vals in
            zip(*(bed_df[c].tolist() for c in columns),
                bed_df.index.tolist())]
    if cluster_mask:
        data = mask_sequences(data, cluster_mask, chromosome_lengths,
                              threshold)
    return data


def different_lengths_or_alignments(itv1, itv2, qlen_diff, diff):
    if (min(itv1.qlen2, itv2.qlen2)
            / max(itv1.qlen2, itv2.qlen2)) >= 1 - qlen_diff:
        return False
    if (min(itv1.n_alignments, itv2.n_alignments)
            / max(itv1.n_alignments, itv2.n_alignments)) >= 1 - diff:
        return False
    return True


class _ChromIndex:
    """Sorted starts + prefix-max ends per chromosome; overlap queries in
    ascending-start order.  ``all_neighbors`` vectorizes the full
    self-join (every interval's overlap list) in one numpy pass."""

    def __init__(self, data):
        self.by_chrom = {}
        for itv in data:
            self.by_chrom.setdefault(itv.chrom, []).append(itv)
        self.arrays = {}
        for chrom, items in self.by_chrom.items():
            starts = np.array([i.start for i in items])
            ends = np.array([i.end for i in items])
            pmax = np.maximum.accumulate(ends)
            self.arrays[chrom] = (starts, ends, pmax, items)

    def search(self, chrom, start, end):
        if chrom not in self.arrays:
            return []
        starts, ends, pmax, items = self.arrays[chrom]
        hi = np.searchsorted(starts, end, side='right')
        lo = np.searchsorted(pmax[:hi], start, side='left')
        if lo >= hi:
            return []
        sel = np.nonzero(ends[lo:hi] >= start)[0] + lo
        return [items[i] for i in sel]


def query_graph(data, overlap_cutoff, jaccard_cutoffs, edge_threshold,
                qlen_diff, n_aln_diff, cfg: ClusterConfig):
    """Returns (match_df, edges list in add order, node first-seen order).

    Exact replay of the reference traversal (cluster.py:187-227),
    computed in closed form:

      1. the full encounter stream is enumerated VECTORIZED in exact
         traversal order (query first-seen order, interval list order,
         ascending-start neighbor order);
      2. ``seen_edges`` dedup and the qlen2/n_alignments gate are static,
         so they reduce the stream to per-query entry arrays without any
         similarity value;
      3. every gated pair's greedy Jaccard is computed in batched device
         calls (a pair's value does not depend on where the traversal
         tests it), and the edge-capped walk's emission set is recovered
         from the values with segmented scans (ops/capwalk.py) — no
         sequential walking at all;
      4. emissions arrive in entry order == traversal order, so
         match/edges/node order are exactly the reference's.
    """
    query_intervals = {}
    for itv in data:
        query_intervals.setdefault(itv.qname, []).append(itv)
    index = _ChromIndex(data)

    def as_tuples(lst):
        return [(i.chrom, i.start, i.end, i.aln_size) for i in lst]

    # integer read ids + per-read padded interval arrays (scale path:
    # string-keyed sets and per-pair tuple lists thrash at 10k+ reads)
    qnames_order = list(query_intervals.keys())
    qid = {q: i for i, q in enumerate(qnames_order)}
    R = len(qnames_order)
    M = cfg.max_intervals_per_read
    chrom_a = np.zeros((R, M), np.int32)
    start_a = np.zeros((R, M), np.int32)
    end_a = np.zeros((R, M), np.int32)
    size_a = np.zeros((R, M), np.float32)
    valid_a = np.zeros((R, M), bool)
    lens_a = np.zeros(R, np.int32)
    itv_rank = {}
    for q, lst in query_intervals.items():
        r = qid[q]
        lens_a[r] = len(lst)
        for i, itv in enumerate(lst):
            itv_rank[id(itv)] = i
            if i < M:
                chrom_a[r, i] = itv.chrom
                start_a[r, i] = itv.start
                end_a[r, i] = itv.end
                size_a[r, i] = itv.aln_size
                valid_a[r, i] = True
    qlen2_arr = np.zeros(R, np.float64)
    naln_arr = np.zeros(R, np.float64)
    for q, lst in query_intervals.items():
        qlen2_arr[qid[q]] = lst[0].qlen2
        naln_arr[qid[q]] = lst[0].n_alignments

    # effective kernel width: the greedy Jaccard's HBM gather traffic and
    # unrolled chain both scale with M, and real interval lists are far
    # below the 32-slot cap (typically <= 4) — run the kernel at the
    # smallest pow2 that covers the dataset; reads beyond it fall back to
    # the exact host path like any over-cap read
    if R:
        mx = int(lens_a.max())
        M_eff = 2
        while M_eff < min(mx, M):
            M_eff *= 2
        if M_eff < M:
            M = M_eff
            chrom_a, start_a, end_a = (chrom_a[:, :M], start_a[:, :M],
                                       end_a[:, :M])
            size_a, valid_a = size_a[:, :M], valid_a[:, :M]

    # ---- 1+2. encounter stream -> first-encounter pairs, vectorized ----
    # Each (pairkey, travkey) encounter is reduced to the pair's earliest
    # traversal position with ONE sort + minimum.reduceat — the encounter
    # stream (all-pairs interval joins at recurrent breakpoints) is 2-10x
    # larger than the unique-pair set and never needs full materialization
    # of per-encounter attribute columns.
    max_itv = max((len(v) for v in query_intervals.values()), default=1)
    max_nc = max((len(v[3]) for v in index.arrays.values()), default=1) + 1
    trav_scale = max_itv * max_nc

    # per-chrom join arrays, shared by the host and device paths
    jobs = []       # (rid_arr, irk_arr, starts, ends, lo, counts, ccum)
    total_enc = 0
    for chrom, (starts, ends, pmax, items) in index.arrays.items():
        nc = len(items)
        if nc == 0:
            continue
        rid_arr = np.fromiter((qid[i.qname] for i in items), np.int64, nc)
        irk_arr = np.fromiter((itv_rank[id(i)] for i in items),
                              np.int64, nc)
        hi = np.searchsorted(starts, ends, side='right')
        lo = np.minimum(np.searchsorted(pmax, starts, side='left'), hi)
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            continue
        total_enc += total
        ccum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        jobs.append((rid_arr, irk_arr, np.asarray(starts),
                     np.asarray(ends), lo, counts, ccum))

    dev_arrays = jaccard.upload_interval_arrays(
        chrom_a, start_a, end_a, size_a, valid_a, np.minimum(lens_a, M))
    host_arrays = (chrom_a, start_a, end_a, size_a, lens_a)
    over = np.nonzero(lens_a > M)[0]

    def host_value(eqs, eos):
        """Exact host greedy Jaccard for reads whose interval lists
        exceed the kernel cap M (cluster.py:140-170 semantics)."""
        jh = np.empty(len(eqs), np.float64)
        nh = np.empty(len(eqs), np.int64)
        for r in range(len(eqs)):
            jh[r], nh[r] = jaccard.jaccard_host(
                as_tuples(query_intervals[qnames_order[int(eqs[r])]]),
                as_tuples(query_intervals[qnames_order[int(eos[r])]]),
                overlap_cutoff)
        return jh, nh

    if total_enc >= cfg.device_enum_min_encounters \
            and trav_scale < (1 << 30) \
            and (chrom_a.max(initial=0) < (1 << 16)):
        # (trav_scale >= 2^30 would overflow the device path's packed
        # 12-byte pair state, and >= 2^16 chromosome ids would overflow
        # capwalk's packed interval tables — pathological datasets stay
        # host-side)
        # scale path: enumeration + per-pair min-reduce AND the capped
        # traversal replay on device
        instrument.record_path('encounter_build', 'device')
        return _query_graph_device(
            jobs, R, max_itv, max_nc, trav_scale, qlen2_arr, naln_arr,
            overlap_cutoff, jaccard_cutoffs, edge_threshold, qlen_diff,
            n_aln_diff, cfg, qnames_order, over, dev_arrays, M,
            host_value, host_arrays)

    instrument.record_path('encounter_build', 'host')
    # Bounded-memory host enumeration: the raw encounter stream is
    # quadratic in recurrent-breakpoint group size, so interval ranges are
    # processed in slices capped at ENCOUNTER_SLICE_CAP encounters, each
    # reduced to per-pair minima before the next slice materializes.
    SLICE_CAP = ENCOUNTER_SLICE_CAP
    red_pk, red_tv = [], []

    tv_span = trav_scale * R + 1        # tv < trav_scale * R

    def _reduce(pk, tv):
        if R * R < (1 << 62) // tv_span:
            # fused single-key sort: with tv in the low bits, the first
            # element of each pk group IS the group minimum — np.sort
            # beats argsort + two fancy-index gathers ~2x at 10M+ keys
            fused = np.sort(pk * tv_span + tv)
            pk_s = fused // tv_span
            grp = np.concatenate([[0], np.nonzero(np.diff(pk_s))[0] + 1])
            return pk_s[grp], fused[grp] % tv_span
        ord1 = np.argsort(pk)
        pk_s = pk[ord1]
        tv_s = tv[ord1]
        grp = np.concatenate([[0], np.nonzero(np.diff(pk_s))[0] + 1])
        return pk_s[grp], np.minimum.reduceat(tv_s, grp)

    slice_jobs = []     # (rid_arr, irk_arr, starts, ends, lo, counts,
                        #  ccum, s0, s1, idt)
    for rid_arr, irk_arr, starts, ends, lo, counts, ccum in jobs:
        nc = len(starts)
        total = int(counts.sum())
        # slice boundaries over query-interval index, capped by encounters
        cuts = [0]
        while cuts[-1] < nc:
            nxt = int(np.searchsorted(ccum, ccum[cuts[-1]] + SLICE_CAP,
                                      side='left'))
            cuts.append(min(max(nxt, cuts[-1] + 1), nc))
        idt = np.int32 if total < 2**31 and nc < 2**31 else np.int64
        for s0, s1 in zip(cuts[:-1], cuts[1:]):
            slice_jobs.append((rid_arr, irk_arr, starts, ends, lo, counts,
                               ccum, s0, s1, idt))

    def _run_slice(job):
        (rid_arr, irk_arr, starts, ends, lo, counts, ccum, s0, s1,
         idt) = job
        cnt_s = counts[s0:s1]
        tot_s = int(cnt_s.sum())
        if tot_s == 0:
            return None
        qx = np.repeat(np.arange(s0, s1, dtype=idt), cnt_s)
        offs = ccum[s0:s1] - ccum[s0]
        nx = (np.arange(tot_s, dtype=idt)
              - np.repeat((offs - lo[s0:s1]).astype(idt), cnt_s))
        keep = ends[nx] >= starts[qx]
        qx, nx = qx[keep], nx[keep]
        a, b = rid_arr[qx], rid_arr[nx]
        ok = a != b
        a, b, qx, nx = a[ok], b[ok], qx[ok], nx[ok]
        if not len(a):
            return None
        pk = np.minimum(a, b) * R + np.maximum(a, b)
        # traversal key: query first-seen order, interval rank, then
        # ascending-start neighbor sequence (nx)
        tv = (a * max_itv + irk_arr[qx]) * max_nc + nx
        return _reduce(pk, tv)

    # slices run sequentially: this image has 2 host cores, so a thread
    # pool over the GIL-releasing numpy work only adds cache contention
    # (measured 1.8x SLOWER at 2e9 encounters)
    for job in slice_jobs:
        rr = _run_slice(job)
        if rr is not None:
            red_pk.append(rr[0])
            red_tv.append(rr[1])
    if red_pk:
        pair_pk, pair_tv = _reduce(np.concatenate(red_pk),
                                   np.concatenate(red_tv))
        del red_pk, red_tv
        eorder = np.argsort(pair_tv)
        tv_e = pair_tv[eorder]
        pk_e = pair_pk[eorder]
        eq = tv_e // trav_scale
        ei = (tv_e // max_nc) % max_itv
        p_lo = pk_e // R
        p_hi = pk_e % R
        eo = np.where(eq == p_lo, p_hi, p_lo)
        q_ok = (np.minimum(qlen2_arr[eq], qlen2_arr[eo])
                / np.maximum(np.maximum(qlen2_arr[eq], qlen2_arr[eo]),
                             1e-12)) >= 1 - qlen_diff
        n_ok = (np.minimum(naln_arr[eq], naln_arr[eo])
                / np.maximum(naln_arr[eq], naln_arr[eo])) >= 1 - n_aln_diff
        gate = q_ok | n_ok          # "not different"
        eq, ei, eo = eq[gate], ei[gate], eo[gate]
    else:
        eq = ei = eo = np.zeros(0, np.int64)

    bounds = np.searchsorted(eq, np.arange(R + 1))
    j64, n_i = capwalk.value_entries(eq, eo, dev_arrays, M,
                                     overlap_cutoff, over, host_value,
                                     host_arrays)
    passv, gated_e = capwalk.pass_flags(j64, n_i, list(jaccard_cutoffs))
    if cfg.exact_cap_replay and len(eq) \
            and (capwalk.pass_counts(passv, bounds)
                 >= edge_threshold).any():
        # some query reaches the soft edge cap: the first-encounter
        # closed form leaves its exactness domain (a capped break leaves
        # pairs un-seen for later re-testing, cluster.py:205-224 — see
        # ops/capwalk.py docstring).  Replay the walk exactly over the
        # full multi-occurrence stream.  The reference values a pair in
        # the direction it is REACHED (overall_jaccard_similarity is a
        # greedy match and n_i is the query side's interval count), so
        # value BOTH directions and let each event look up its own —
        # reusing only the first-encounter direction could flip pass/
        # fail on re-tested pairs (round-4 advisor finding).
        j64r, n_ir = capwalk.value_entries(eo, eq, dev_arrays, M,
                                           overlap_cutoff, over,
                                           host_value, host_arrays)
        passr, _ = capwalk.pass_flags(j64r, n_ir, list(jaccard_cutoffs))
        pk_v = np.minimum(eq, eo) * R + np.maximum(eq, eo)
        vord = np.argsort(pk_v)
        eq_w, eo_w, j_w = _exact_capped_walk(
            jobs, R, max_itv, max_nc, edge_threshold,
            pk_v[vord], eq[vord],
            (j64[vord], n_i[vord], passv[vord]),
            (j64r[vord], n_ir[vord], passr[vord]))
        return _emit_from_pairs(eq_w, eo_w, j_w, qnames_order)
    rc = np.ones(len(eq), bool)
    rc[1:] = (eq[1:] != eq[:-1]) | (ei[1:] != ei[:-1])
    emit = capwalk.replay(passv, gated_e, rc, eq, bounds, edge_threshold)
    idx_e = np.flatnonzero(emit)
    return _emit_outputs(idx_e, eo[idx_e], j64[idx_e], bounds,
                         qnames_order)


class _ConsumedSet:
    """Grow-only int64 membership set with vectorized queries (sorted
    base + small pending buffers, merged when the buffer fills)."""

    def __init__(self):
        self._sorted = np.empty(0, np.int64)
        self._pending: list[np.ndarray] = []
        self._npend = 0

    def contains(self, x: np.ndarray) -> np.ndarray:
        if len(self._sorted):
            ix = np.searchsorted(self._sorted, x)
            ix = np.minimum(ix, len(self._sorted) - 1)
            out = self._sorted[ix] == x
        else:
            out = np.zeros(len(x), bool)
        for p in self._pending:
            out |= np.isin(x, p)
        return out

    def add(self, arr: np.ndarray):
        if not len(arr):
            return
        self._pending.append(np.asarray(arr, np.int64))
        self._npend += len(arr)
        if self._npend > 65536 or len(self._pending) > 12:
            self._sorted = np.unique(np.concatenate(
                [self._sorted, *self._pending]))
            self._pending = []
            self._npend = 0


def _first_occurrence_mask(pk: np.ndarray) -> np.ndarray:
    """True at each value's first occurrence (positional order)."""
    n = len(pk)
    if n < 2:
        return np.ones(n, bool)
    o = np.argsort(pk, kind='stable')
    ps = pk[o]
    f = np.empty(n, bool)
    f[0] = True
    f[1:] = ps[1:] != ps[:-1]
    out = np.empty(n, bool)
    out[o] = f
    return out


def _exact_capped_walk(jobs, R, max_itv, max_nc, edge_threshold,
                       pk_valued, eq_valued, fwd_vals, rev_vals):
    """Exact sequential replay of the reference traversal
    (cluster.py:187-227) over the FULL multi-occurrence encounter
    stream, used when some query reaches the soft edge cap.

    The dynamic part of the reference walk is only ``seen_edges``
    (which pairs each reached encounter consumes) and the per-query
    edge counter; every pair's (jaccard, n_i, pass) is static and comes
    precomputed from the batch valuing (pk_valued sorted).  Queries
    whose fresh pass count stays under the cap are replayed in one
    vectorized step; capped queries fall back to run-by-run vector ops
    (runs = (read, interval) neighbor lists, reference's inner loops).

    Returns (eq, eo, j) per emission in exact traversal order.

    Memory is bounded: the multi-occurrence stream is materialized in
    CONTIGUOUS QUERY CHUNKS of ~ENCOUNTER_SLICE_CAP encounters each (a
    query's walk only ever needs its own segment; consumed-pair state
    carries across chunks in the _ConsumedSet) — materializing the
    whole stream at once (~80 B/encounter transients) could exhaust
    host RAM exactly on the dense-breakpoint datasets where queries
    cap (round-4 advisor finding).
    """
    # per-read event upper bounds (pre-filter) for chunk boundaries
    ev_per_read = np.zeros(R + 1, np.int64)
    for rid_arr, irk_arr, starts, ends, lo, counts, ccum in jobs:
        np.add.at(ev_per_read, rid_arr, counts)
    cum = np.cumsum(ev_per_read[:R])
    total_ev = int(cum[-1]) if R else 0
    if total_ev == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    n_chunks = max(1, -(-total_ev // ENCOUNTER_SLICE_CAP))
    targets = (np.arange(1, n_chunks) * (total_ev / n_chunks))
    splits = np.unique(np.searchsorted(cum, targets) + 1)
    r_bounds = np.concatenate([[0], splits, [R]])
    r_bounds = np.unique(r_bounds)

    cons = _ConsumedSet()
    T = int(edge_threshold)
    out_eq, out_eo, out_j = [], [], []
    for r0, r1 in zip(r_bounds[:-1], r_bounds[1:]):
        res = _exact_walk_chunk(jobs, R, max_itv, max_nc, T, pk_valued,
                                eq_valued, fwd_vals, rev_vals, cons,
                                int(r0), int(r1))
        if res is not None:
            out_eq.append(res[0])
            out_eo.append(res[1])
            out_j.append(res[2])
    if not out_eq:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float64)
    return (np.concatenate(out_eq), np.concatenate(out_eo),
            np.concatenate(out_j))


def _exact_walk_chunk(jobs, R, max_itv, max_nc, T, pk_valued,
                      eq_valued, fwd_vals, rev_vals, cons, r0, r1):
    """Materialize + walk the stream segment of queries [r0, r1)
    (helper of _exact_capped_walk; ``cons`` carries consumed pairs
    across chunks)."""
    pks, tvs = [], []
    for rid_arr, irk_arr, starts, ends, lo, counts, ccum in jobs:
        qsel = np.flatnonzero((rid_arr >= r0) & (rid_arr < r1)
                              & (counts > 0))
        if not len(qsel):
            continue
        cnt_sel = counts[qsel]
        tot = int(cnt_sel.sum())
        qx = np.repeat(qsel, cnt_sel)
        base = np.concatenate([[0], np.cumsum(cnt_sel)])[:-1]
        nx = (np.arange(tot, dtype=np.int64)
              - np.repeat(base - lo[qsel], cnt_sel))
        keep = ends[nx] >= starts[qx]
        qx, nx = qx[keep], nx[keep]
        a, b = rid_arr[qx], rid_arr[nx]
        ok = a != b
        a, b, qx, nx = a[ok], b[ok], qx[ok], nx[ok]
        if not len(a):
            continue
        pks.append(np.minimum(a, b) * R + np.maximum(a, b))
        tvs.append((a * max_itv + irk_arr[qx]) * max_nc + nx)
    if not pks:
        return None
    pk = np.concatenate(pks)
    tv = np.concatenate(tvs)
    order = np.argsort(tv)              # tv unique: (read, rank, npos)
    pk, tv = pk[order], tv[order]
    E = len(pk)
    eq = tv // (max_itv * max_nc)
    run = tv // max_nc
    p_lo, p_hi = pk // R, pk % R
    oth = np.where(eq == p_lo, p_hi, p_lo)

    # ---- static per-event flags from the batch pair values -----------
    # each event uses ITS direction's (jaccard, n_i, pass): fwd_vals
    # were valued with the stored eq_valued as query side, rev_vals
    # with the other side
    vix = np.searchsorted(pk_valued, pk)
    vix_c = np.minimum(vix, max(len(pk_valued) - 1, 0))
    hasv = ((vix < len(pk_valued)) & (pk_valued[vix_c] == pk)
            if len(pk_valued) else np.zeros(E, bool))
    j_f, n_f, p_f = fwd_vals
    j_r, n_r, p_r = rev_vals
    is_fwd = eq == eq_valued[vix_c]
    gated = hasv & np.where(is_fwd, n_f[vix_c] > 0, n_r[vix_c] > 0)
    passf = hasv & np.where(is_fwd, p_f[vix_c], p_r[vix_c])
    jval = np.where(hasv, np.where(is_fwd, j_f[vix_c], j_r[vix_c]), 0.0)

    seg_bounds = np.searchsorted(eq, np.arange(r0, r1 + 1))
    emit_pos: list[int] = []
    for r in range(r1 - r0):
        s0, s1 = int(seg_bounds[r]), int(seg_bounds[r + 1])
        if s0 == s1:
            continue
        pk_s = pk[s0:s1]
        fresh = ~cons.contains(pk_s)
        firsts = _first_occurrence_mask(pk_s)
        freshf = fresh & firsts
        p_all = passf[s0:s1] & freshf
        if int(p_all.sum()) < T:
            # no cap: every encounter is reached; first occurrences of
            # unconsumed pairs are consumed, passing ones emit
            cons.add(pk_s[freshf])
            emit_pos.extend((s0 + np.flatnonzero(p_all)).tolist())
            continue
        # capped query: replay its runs sequentially
        run_s = run[s0:s1]
        rstarts = np.flatnonzero(
            np.concatenate([[True], run_s[1:] != run_s[:-1]]))
        rstops = np.concatenate([rstarts[1:], [s1 - s0]])
        e = 0
        local: set[int] = set()
        seg_consumed: list[np.ndarray] = []
        for a0, a1 in zip(rstarts, rstops):
            a0, a1 = int(a0), int(a1)
            pk_r = pk_s[a0:a1]
            fr = fresh[a0:a1] & _first_occurrence_mask(pk_r)
            if local:
                fr = fr & ~np.isin(
                    pk_r, np.fromiter(local, np.int64, len(local)))
            if e < T:
                pr = passf[s0 + a0:s0 + a1] & fr
                tot_p = int(pr.sum())
                if e + tot_p < T:
                    consumed = pk_r[fr]
                    emit_pos.extend(
                        (s0 + a0 + np.flatnonzero(pr)).tolist())
                    e += tot_p
                else:
                    cum = np.cumsum(pr)
                    cappos = int(np.argmax(cum >= T - e))
                    consumed = pk_r[:cappos + 1][fr[:cappos + 1]]
                    emit_pos.extend(
                        (s0 + a0
                         + np.flatnonzero(pr[:cappos + 1])).tolist())
                    e = T
            else:
                g = fr & gated[s0 + a0:s0 + a1]
                if g.any():
                    fv = int(np.argmax(g))
                    consumed = pk_r[:fv + 1][fr[:fv + 1]]
                    if passf[s0 + a0 + fv]:
                        emit_pos.append(s0 + a0 + fv)
                        e += 1
                else:
                    consumed = pk_r[fr]
            if len(consumed):
                local.update(consumed.tolist())
                seg_consumed.append(consumed)
        if seg_consumed:
            cons.add(np.concatenate(seg_consumed))
    pos = np.asarray(emit_pos, np.int64)
    return eq[pos], oth[pos], jval[pos]


# re-export for _exact_capped_walk chunking (defined above)


def _emit_outputs(idx, eo_e, j_e, bounds, qnames_order):
    """match/edges/node order from the replay's emissions, which arrive
    in exact traversal order (ascending global entry index; queries in
    first-seen order) — identical to the reference's sequential emit."""
    eq_e = np.searchsorted(bounds, idx, side='right') - 1
    return _emit_from_pairs(eq_e, eo_e, j_e, qnames_order)


def _emit_from_pairs(eq_e, eo_e, j_e, qnames_order):
    match = set()
    edges = []
    node_pos = {}
    for qa, qb, j in zip(eq_e, eo_e, j_e):
        name_a = qnames_order[int(qa)]
        name_b = qnames_order[int(qb)]
        match.add((name_a, name_b, float(j)))
        if name_a not in node_pos:
            node_pos[name_a] = len(node_pos)
        if name_b not in node_pos:
            node_pos[name_b] = len(node_pos)
        edges.append((name_a, name_b))
    rows = list(match)
    match_df = Table({
        'query1': np.array([r[0] for r in rows], object),
        'query2': np.array([r[1] for r in rows], object),
        'jaccard_similarity': np.array([r[2] for r in rows], np.float64)})
    return match_df, edges, node_pos


def _query_graph_device(jobs, R, max_itv, max_nc, trav_scale, qlen2_arr,
                        naln_arr, overlap_cutoff, jaccard_cutoffs,
                        edge_threshold, qlen_diff, n_aln_diff,
                        cfg: ClusterConfig, qnames_order, over,
                        dev_arrays, M, host_value, host_arrays=None):
    """Scale path of query_graph: the encounter stream is enumerated and
    min-reduced on DEVICE (ops/encounters.py), entries stay
    device-resident, and the edge-capped traversal is replayed as a
    device program (ops/capwalk.py) — every gated pair is valued in
    chunked batches and the emission set falls out of segmented scans,
    so the whole walk costs O(1) host syncs instead of round 2's
    O(rounds).  Emissions are identical to the host path
    (tests/test_cluster.py asserts equality)."""
    from fslr_tpu.ops import capwalk as cw
    from fslr_tpu.ops import encounters

    ents = encounters.build_entries(
        [encounters.ChromJob(starts=s, ends=e, lo=lo, ccum=ccum, rid=rid,
                             irk=irk)
         for (rid, irk, s, e, lo, counts, ccum) in jobs],
        R, max_itv, max_nc, qlen2_arr, naln_arr,
        1.0 - qlen_diff, 1.0 - n_aln_diff, cfg.enum_slice_cap,
        merge_cap=cfg.enum_merge_cap,
        spill_min_encounters=cfg.enum_spill_min_encounters)
    bounds = ents.bounds
    cutoffs = list(jaccard_cutoffs)
    if isinstance(ents, encounters.HostEntrySet):
        # spill fallback: entries live in host RAM; valuing + replay run
        # in query-aligned chunks (eq reconstructed per chunk — a global
        # np.repeat is 27 GB at config-5 scale)
        ei_s, eo_s, _ = ents.fetch_all()
        idx_e, eo_e, j_e = cw.value_and_replay_host(
            None, ei_s, eo_s, bounds, dev_arrays, M, overlap_cutoff,
            cutoffs, edge_threshold, over, host_value, host_arrays)
    else:
        idx_e, eo_e, j_e = cw.resolve_device(
            ents.device_buckets(), bounds, max_itv, max_nc, dev_arrays,
            M, overlap_cutoff, cutoffs, edge_threshold, over, host_value)
    # the scale paths keep the closed-form first-encounter replay even
    # when a query caps (the exact multi-occurrence walk is host-path
    # only; round-4 advisor: users should know when that semantics
    # applies) — a query emitting edge_threshold edges has (almost
    # certainly) hit the soft cap
    if len(idx_e):
        eq_e = np.searchsorted(bounds, idx_e, side='right') - 1
        n_cap = int((np.bincount(eq_e, minlength=R)
                     >= edge_threshold).sum())
        if n_cap:
            print(f'note: {n_cap} queries reached the soft edge cap '
                  f'({edge_threshold}) on the at-scale clustering path; '
                  f'capped walks use first-encounter edge semantics '
                  f'(measured vs the reference walk: partitions equal on '
                  f'99.6% of adversarial capped frames, divergence only '
                  f'splits over-cap-bridged clusters; see ops/capwalk.py '
                  f'exactness domain + tools/cap_sweep.py)',
                  file=sys.stderr)
    return _emit_outputs(idx_e, eo_e, j_e, bounds, qnames_order)



def get_subgraphs(edges, node_pos):
    """Connected components as a list of qname sets, ordered by first-seen
    node (networkx iteration order).

    Under an active mesh the edge list is split into per-device shards and
    merged with an all-gather before label propagation
    (parallel/cluster_merge.py — the multi-host path where each process
    contributes the edges of its own read shard, SURVEY section 5.8); the
    component sets and their order are identical to the local path because
    both label by smallest node id and the ordering scan below depends
    only on membership."""
    if not edges:
        return []
    n = len(node_pos)
    names = [None] * n
    for name, pos in node_pos.items():
        names[pos] = name
    earr = np.array([[node_pos[a], node_pos[b]] for a, b in edges],
                    dtype=np.int32)
    from fslr_tpu.parallel import dispatch
    mesh = dispatch.active_mesh()
    if mesh is not None and mesh.devices.size > 1:
        from fslr_tpu.parallel.cluster_merge import merged_components
        n_dev = mesh.devices.size
        per = -(-len(earr) // n_dev)
        shards = [earr[i * per:(i + 1) * per] for i in range(n_dev)]
        labels = np.asarray(merged_components(mesh, shards, n, per))
    else:
        try:
            labels = np.asarray(
                components.connected_components_padded(earr, n))
        except Exception as e:
            if 'RESOURCE_EXHAUSTED' not in str(e):
                raise
            labels = None
        if labels is None:
            # transient HBM pressure (shared chip / post-build allocator
            # state): components are pure graph logic, so a host
            # union-find is observably identical — get_subgraphs orders
            # by first-seen node, independent of label values
            print('WARNING: device components hit RESOURCE_EXHAUSTED; '
                  'computing connected components on host',
                  file=sys.stderr)
            from scipy.sparse import coo_matrix
            from scipy.sparse.csgraph import connected_components as _cc
            m = coo_matrix((np.ones(len(earr), np.int8),
                            (earr[:, 0], earr[:, 1])), shape=(n, n))
            _, labels = _cc(m, directed=False)
    comp_order = []
    comp_members = {}
    for pos in range(n):
        lbl = int(labels[pos])
        if lbl not in comp_members:
            comp_members[lbl] = set()
            comp_order.append(lbl)
        comp_members[lbl].add(names[pos])
    return [comp_members[lbl] for lbl in comp_order]


def choose_alignment(bed_file):
    """Representative reads: per cluster, keep every row of the read whose
    alignments have the highest mean alignment_score; ties resolve to the
    earliest row, matching the reference's per-cluster scan
    (/root/reference/fslr/cluster.py:237-254).  The rows come back with
    their reads' mean score as ``avg_alignment_score``."""
    bed = bed_file.copy()
    q_codes, nq = _group_codes(bed['qname'])
    score = bed['alignment_score'].astype(np.float64)
    avg = (np.bincount(q_codes, score, nq)
           / np.bincount(q_codes, minlength=nq))[q_codes]
    bed['avg_alignment_score'] = avg
    c_codes, nc = _group_codes(bed['cluster'])
    # first row of each cluster holding its maximum mean score
    order = np.lexsort((np.arange(len(bed)), -avg, c_codes))
    first = np.ones(len(order), bool)
    first[1:] = c_codes[order[1:]] != c_codes[order[:-1]]
    winners = set(bed['qname'][order[first]].tolist())
    return bed.take(np.array([q in winners for q in bed['qname'].tolist()],
                             bool))


@dataclasses.dataclass
class ClusterResult:
    cluster_bed: Table | None
    representative_bed: Table | None
    no_clusters: bool
    subgraphs: list | None = None


def cluster_stage(bed_file, chromosome_lengths: dict,
                  cfg: ClusterConfig) -> ClusterResult:
    """The main.py:207-352 clustering block.  ``bed_file`` is the mappings
    table (a Table, or any frame :meth:`Table.of` accepts)."""
    bed_file = Table.of(bed_file)
    chromosome_mask = set()
    if cfg.cluster_mask:
        allowed = set(bed_file['chrom'].tolist())
        for item in cfg.cluster_mask:
            if item in allowed or item == 'subtelomere':
                chromosome_mask.add(item)

    bed_file, chr_lengths, chromosome_mask, cmap = rename_chromosomes(
        bed_file, chromosome_lengths, chromosome_mask)
    if cfg.filter_false:
        bed_file = delete_false(bed_file)

    fillings = keep_fillings(bed_file)
    data = prepare_data(fillings, chromosome_mask, chr_lengths,
                        cfg.subtelomere_threshold)
    if cfg.filter_high_coverage:
        # The reference passes the fillings DataFrame straight into
        # filter_high_coverage, whose `for aln in data: aln.chrom` loop
        # cannot work on a DataFrame (main.py:234-235, cluster.py:70-77) —
        # the flag crashes upstream.  We implement the documented intent:
        # drop IntervalItems whose midpoint coverage exceeds the threshold.
        data = filter_high_coverage(data, bed_file, chr_lengths,
                                    cfg.high_coverage_threshold)

    match_df, edges, node_pos = query_graph(
        data, cfg.overlap, list(cfg.jaccard_cutoffs), cfg.edge_threshold,
        cfg.qlen_diff, cfg.n_alignment_diff, cfg)
    subgraphs = get_subgraphs(edges, node_pos)

    n_nodes = len(node_pos)
    if len(subgraphs) == n_nodes:       # true iff no edges
        return ClusterResult(None, None, True, subgraphs)

    # cluster id = subgraph position, n_reads = its size; reads in no
    # subgraph become singleton clusters numbered after the subgraphs in
    # first-appearance order.  As in the reference's left merge + fillna,
    # the two columns are integers when every read is clustered and
    # floats otherwise.
    member = {q: k for k, grp in enumerate(subgraphs) for q in grp}
    sizes = [len(grp) for grp in subgraphs]
    qnames = bed_file['qname'].tolist()
    cl = [member.get(q) for q in qnames]
    if all(c is not None for c in cl):
        cluster = np.array(cl, np.int64)
        n_reads = np.array([sizes[c] for c in cl], np.int64)
    else:
        single_id: dict = {}
        cluster = np.empty(len(cl), np.float64)
        n_reads = np.ones(len(cl), np.float64)
        for i, (q, c) in enumerate(zip(qnames, cl)):
            if c is None:
                c = single_id.setdefault(q, len(subgraphs) + len(single_id))
            else:
                n_reads[i] = sizes[c]
            cluster[i] = c
    bed_file = Table({**bed_file.to_dict(), 'cluster': cluster,
                      'n_reads': n_reads})
    bed_file = chrom_to_str(bed_file, cmap)
    rep = choose_alignment(bed_file)
    return ClusterResult(bed_file, rep, False, subgraphs)
