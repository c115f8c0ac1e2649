"""Repeat-block scoring for the junk filter, batched on device.

Replicates the observable semantics of the reference junk filter
(/root/reference/fslr/filter_junk_from_fq.py):

  * ``find_lower_case`` block detection (:15-27) becomes run detection over
    the device repeat mask (ops/tantan.py) via cumsum segment ids;
  * ``telmer_pct`` (:110-117) becomes a 5^6-entry membership-table gather
    over rolling 6-mer codes, segment-summed per block;
  * ``compute_rep`` (:30-61) — a dict-probing scan over k = 2..6 k-mers with
    exponential-decay reuse scoring — becomes a segmented sort: sorting
    (block, kmer-code, position) keys makes "distance to the previous
    occurrence of the same k-mer within the block" a neighbour difference,
    turning the per-read dict into pure vector ops.

    Exact quirks preserved: the reference iterates ``range(len(s) - k)`` so
    the final in-block k-mer is never visited, and only positions with
    block-relative index ii > k contribute to the score
    (amount = exp(-decay * (diff - 1)), decay = 0.25 / k,
    total_seen = sum_k max(0, len - 2k - 1)).

A block is junk iff  length > 150  and  telmer_pct <= 0.3  and  rep >= 0.3
(:123,:141-150); a read is dropped as junk iff any of its blocks qualifies
(the reference breaks at the first qualifying block — same decision).
"""

from __future__ import annotations

import functools
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np

from fslr_tpu.config import JunkFilterConfig
from fslr_tpu.encode import NUM_SYMBOLS, encode, revcomp_str

# Telomere variant hexamers, as in the reference
# (/root/reference/fslr/filter_junk_from_fq.py:208-209).
TEL_TARGETS = ["CCCTAA", "CCCTGA", "CCCGAA", "CCCTAC", "CCCTCA", "CCCCAA",
               "CCCTTA", "CCCTAT", "CCCTAG", "CCCAAA", "CCCACT", "CCCCAT",
               "CCCGCA", "CCCGCT", "CCCTCT"]


def tel_rotations(targets=None) -> set[str]:
    """Rotation closure exactly as the reference builds it: deque.rotate()
    applied len-1 times per token, so the identity rotation is EXCLUDED
    (fslr/filter_junk_from_fq.py:191-204), over targets + their reverse
    complements (:208-209)."""
    targets = list(targets or TEL_TARGETS)
    targets = targets + [revcomp_str(t) for t in targets]
    rot: set[str] = set()
    for t in targets:
        d = deque(t)
        for _ in range(len(t) - 1):
            d.rotate()
            rot.add(''.join(d))
    return rot


@functools.lru_cache(maxsize=4)
def telomere_table(k: int = 6) -> np.ndarray:
    """(5^k,) bool membership table over base-5 k-mer codes."""
    table = np.zeros(NUM_SYMBOLS ** k, dtype=bool)
    for s in tel_rotations():
        codes = encode(s)
        code = 0
        for c in codes:
            code = code * NUM_SYMBOLS + int(c)
        table[code] = True
    return table


def _kmer_codes_2d(seq, k):
    """(B, L) base-5 rolling k-mer codes; positions with i+k > L read padding."""
    B, L = seq.shape
    c = jnp.zeros((B, L), jnp.int32)
    for p in range(k):
        col = jnp.pad(seq[:, p:], ((0, 0), (0, p)), constant_values=4)
        c = c * NUM_SYMBOLS + col.astype(jnp.int32)
    return c


def _runs_and_tel(seq, lens, mask, tel_table):
    """Shared traced prelude: repeat-run segment ids, per-run length /
    read id / start column, and telomere 6-mer content per run."""
    B, L = seq.shape
    N = B * L
    R = N // 2 + 2            # max possible runs + trash segment
    trash = R - 1

    pos = jnp.arange(L)[None, :]
    inlen = pos < lens[:, None]
    mask = mask & inlen

    prev = jnp.pad(mask, ((0, 0), (1, 0)))[:, :-1]
    starts = mask & ~prev
    rid2d = jnp.cumsum(starts.reshape(-1)).reshape(B, L) - 1
    rid2d = jnp.where(mask, rid2d, trash)

    flat_rid = rid2d.reshape(-1)
    flat_mask = mask.reshape(-1)
    row = jnp.broadcast_to(jnp.arange(B)[:, None], (B, L)).reshape(-1)
    col = jnp.broadcast_to(pos, (B, L)).reshape(-1)

    blen = jax.ops.segment_sum(flat_mask.astype(jnp.int32), flat_rid, R)
    bid = jax.ops.segment_max(jnp.where(flat_mask, row, -1), flat_rid, R)
    bstart = jax.ops.segment_min(jnp.where(flat_mask, col, L + 1), flat_rid, R)

    # --- telomere content per block ------------------------------------
    c6 = _kmer_codes_2d(seq, 6)
    rid_k5 = jnp.pad(rid2d[:, 5:], ((0, 0), (0, 5)), constant_values=trash)
    valid6 = mask & (rid2d == rid_k5)
    member = tel_table[jnp.clip(c6, 0, tel_table.shape[0] - 1)] & valid6
    tel_cnt = jax.ops.segment_sum(
        member.reshape(-1).astype(jnp.int32), flat_rid, R)
    tel_tot = jnp.maximum(blen - 5, 1)
    tel_pct = tel_cnt.astype(jnp.float32) / tel_tot.astype(jnp.float32)
    return (mask, rid2d, flat_rid, flat_mask, col, blen, bid, bstart,
            tel_pct, R, trash)


@functools.partial(jax.jit, static_argnames=('min_block_len', 'tel_codes'))
def _block_gates_impl(seq, lens, mask, tel_codes, min_block_len,
                      tel_thresh):
    """Cheap per-read gate: does any repeat run pass the length + telomere
    conditions of the junk test?  Only gated reads need the (much more
    expensive) segmented-sort rep score — junk requires blen > 150 AND
    tel_pct <= 0.3 AND rep >= 0.3 (filter_junk_from_fq.py:141-150), so a
    False gate decides junk=False without computing rep.

    Implemented as pure row-wise scans (cumsum/cummax along L) — the
    segment-id formulation scatter-added into B*L/2 segments.  Runs are
    maximal masked intervals, so "previous run start" is a cummax over
    start positions and per-run telomere counts are differences of an
    inclusive cumsum — no segment ids needed.  Telomere 6-mer membership
    is a comparison against the ~150 rotation codes (elementwise, fused)
    instead of a 5^6-table gather."""
    B, L = seq.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    mask = mask & (pos < lens[:, None])

    prev = jnp.pad(mask, ((0, 0), (1, 0)))[:, :-1]
    nxt = jnp.pad(mask, ((0, 0), (0, 1)))[:, 1:]
    is_start = mask & ~prev
    is_end = mask & ~nxt

    # member[p]: positions p..p+5 all masked (same run, inside len) and
    # the 6-mer at p is a telomere rotation — identical to the
    # rid2d == rid_k5 test in _runs_and_tel (contiguous masked positions
    # share a run).
    contig6 = mask
    for j in range(1, 6):
        contig6 = contig6 & jnp.pad(mask[:, j:], ((0, 0), (0, j)))
    c6 = _kmer_codes_2d(seq, 6)
    member = jnp.zeros_like(mask)
    for code in tel_codes:
        member = member | (c6 == code)
    member = member & contig6

    S = jnp.cumsum(member.astype(jnp.int32), axis=1)          # inclusive
    E = S - member.astype(jnp.int32)                          # exclusive
    # value at the most recent run start (E and pos are nondecreasing)
    base = jax.lax.cummax(jnp.where(is_start, E, -1), axis=1)
    s_pos = jax.lax.cummax(jnp.where(is_start, pos, -1), axis=1)

    blen = pos - s_pos + 1
    tel_cnt = S - base
    tel_tot = jnp.maximum(blen - 5, 1)
    tel_pct = tel_cnt.astype(jnp.float32) / tel_tot.astype(jnp.float32)
    gate_block = (is_end & (blen > min_block_len)
                  & (tel_pct <= tel_thresh))
    return jnp.any(gate_block, axis=1)


@functools.partial(jax.jit, static_argnames=('min_block_len',))
def _block_stats_impl(seq, lens, mask, tel_table, min_block_len,
                      tel_thresh, rep_thresh):
    B, L = seq.shape
    (mask, rid2d, flat_rid, flat_mask, col, blen, bid, bstart,
     tel_pct, R, trash) = _runs_and_tel(seq, lens, mask, tel_table)

    # --- compute_rep per block (segmented lexsort over k = 2..6) -------
    # int32 keys only (the engine traces without x64): stable lexsort by
    # (block run id, k-mer code, position) makes "previous occurrence of
    # the same k-mer within the block" the preceding element.
    tot_amount = jnp.zeros(R, jnp.float32)
    for k in (2, 3, 4, 5, 6):
        ck = _kmer_codes_2d(seq, k).reshape(-1)
        rid_kk = jnp.pad(rid2d[:, k:], ((0, 0), (0, k)),
                         constant_values=trash).reshape(-1)
        # visited iff the k-mer AND position i+k are inside the same block
        # (reference range(len(s)-k) skips the final in-block k-mer)
        visited = flat_mask & (flat_rid == rid_kk)
        srid_in = jnp.where(visited, flat_rid, trash)
        order = jnp.lexsort((col, ck, srid_in))
        srid = srid_in[order]
        scode = ck[order]
        scol = col[order]
        prid = jnp.roll(srid, 1)
        pcode = jnp.roll(scode, 1)
        pcol = jnp.roll(scol, 1)
        same = (srid == prid) & (scode == pcode) & (srid != trash)
        same = same.at[0].set(False)
        d = scol - pcol
        decay = 0.25 / k
        amount = jnp.where(same,
                           jnp.exp(-decay * (d.astype(jnp.float32) - 1.0)),
                           0.0)
        ii = scol - bstart[srid]
        amount = jnp.where(ii > k, amount, 0.0)
        tot_amount = tot_amount + jax.ops.segment_sum(amount, srid, R)

    total_seen = jnp.zeros(R, jnp.int32)
    for k in (2, 3, 4, 5, 6):
        total_seen = total_seen + jnp.maximum(blen - 2 * k - 1, 0)
    rep = jnp.where(total_seen > 0,
                    tot_amount / jnp.maximum(total_seen, 1).astype(jnp.float32),
                    0.0)

    junk_block = ((blen > min_block_len) & (tel_pct <= tel_thresh)
                  & (rep >= rep_thresh))
    junk_block = junk_block & (jnp.arange(R) != trash)
    junk_read = jnp.zeros(B, jnp.bool_).at[bid].max(
        junk_block, mode='drop')
    return junk_read, (blen, tel_pct, rep, bid, bstart)


def junk_blocks(seq, lens, mask, cfg: JunkFilterConfig):
    """Per-read junk decision (B,) bool from the repeat mask."""
    junk, _ = junk_blocks_debug(seq, lens, mask, cfg)
    return junk


@functools.lru_cache(maxsize=4)
def telomere_codes(k: int = 6) -> tuple[int, ...]:
    """Sorted base-5 codes of the telomere rotation closure."""
    return tuple(sorted(int(i) for i in
                        np.flatnonzero(telomere_table(k))))


def junk_gates(seq, lens, mask, cfg: JunkFilterConfig):
    """Per-read (B,) bool: True iff some repeat run passes the block-length
    + telomere gates, i.e. the read MIGHT be junk and needs the rep score.
    junk_blocks(...) implies junk_gates(...)."""
    return _block_gates_impl(
        jnp.asarray(seq), jnp.asarray(lens, jnp.int32), jnp.asarray(mask),
        telomere_codes(6), cfg.min_block_length,
        float(cfg.telomere_pct_threshold))


def junk_blocks_debug(seq, lens, mask, cfg: JunkFilterConfig):
    """Junk decision plus per-run (blen, tel_pct, rep, read_id, start) arrays
    for oracle tests."""
    table = jnp.asarray(telomere_table(6))
    return _block_stats_impl(
        jnp.asarray(seq), jnp.asarray(lens, jnp.int32), jnp.asarray(mask),
        table, cfg.min_block_length,
        float(cfg.telomere_pct_threshold), float(cfg.rep_threshold))
