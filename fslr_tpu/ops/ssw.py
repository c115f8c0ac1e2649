"""Batched Smith-Waterman: a plain JAX scan and a CUDA kernel (ops/cuda.py).

This single kernel backs both reference use-sites of SIMD Smith-Waterman
(scikit-bio StripedSmithWaterman): the concatemer scan
(/root/reference/fslr/filter_junk_from_fq.py:92,103, score >= 28 decision) and
primer identification / trimming
(/root/reference/fslr/find_reads_with_primers.py:57-58, normalized score +
target_begin / target_end_optimal for the trim).

Layout (not a transcription of the CPU striped layout):
  * query positions j live on 128 lanes (primers/targets are <= 68 bp),
  * batch elements are rows,
  * target positions i are scanned sequentially.

The affine-gap recurrence has an in-row dependency (gaps consuming query
bases, Farrar's "lazy F" loop).  We replace it with a closed form: with
first-gap cost fg >= gap-extend e,

    F[i][j] = max_{k<j}( Hno[i][k] - fg - (j-k-1)*e )
            = cummax_{k<=j-1}( Hno[i][k] + k*e ) - fg - (j-1)*e

where Hno is H computed without F contributions.  (Opening a new query-gap
from a cell that itself ends in a query-gap is never better than extending
the original gap when fg >= e, so Hno may replace H inside the cummax.)
The cummax is a log2(128)-step shifted-max over lanes.

End-position semantics replicate the ssw library: per-lane running maxima
with strict ">" updates give, per column j, the first row where the column
maximum is reached; the reported query end is the smallest j achieving the
global maximum (ssw's maxColumn scan) and the reported target end is the
first row at which the global maximum is reached.  ``target_begin`` is
recovered ssw-style by re-aligning reversed prefixes.

Gap conventions (config.ScoringConfig.gap_open_is_first_base):
  * ssw / scikit-bio: gap of length g costs open + (g-1)*extend,
  * bwa (-O5 -E2):    gap of length g costs open + g*extend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from fslr_tpu.config import ScoringConfig
from fslr_tpu.ops import cuda

NEG = -1e30
QP = 128          # query lanes (max query length supported by this layout)


def pad_rows_pow2(n: int, minimum: int = 256) -> int:
    """Next power-of-two row count (>= minimum): varying batch sizes reuse
    a handful of compiled shapes instead of recompiling per batch."""
    m = minimum
    while m < n:
        m *= 2
    return m


def first_gap_cost(sc: ScoringConfig) -> float:
    return float(sc.gap_open if sc.gap_open_is_first_base
                 else sc.gap_open + sc.gap_extend)


def _shift_right(x, d, fill, jidx):
    """x[j] -> x[j-d], positions j < d become ``fill``."""
    return jnp.where(jidx >= d, jnp.roll(x, d, axis=1), fill)


def _cummax_exclusive(x, jidx):
    """max over k <= j-1 of x[k]; -inf at j == 0."""
    y = _shift_right(x, 1, NEG, jidx)
    d = 1
    while d < QP:
        y = jnp.maximum(y, _shift_right(y, d, NEG, jidx))
        d *= 2
    return y


def _sw_step(H, E, bestH, bestI, s, i_idx, tmask, qmask, jidx, fg, ext):
    """One target row of the batched DP.  All arrays are (BT, QP) f32."""
    E = jnp.maximum(E - ext, H - fg)
    diag = _shift_right(H, 1, 0.0, jidx)
    Hno = jnp.maximum(jnp.maximum(diag + s, E), 0.0)
    Cm = _cummax_exclusive(Hno + jidx * ext, jidx)
    F = Cm - fg - (jidx - 1.0) * ext
    H = jnp.maximum(Hno, F)
    upd = (H > bestH) & tmask & qmask
    bestH = jnp.where(upd, H, bestH)
    bestI = jnp.where(upd, i_idx, bestI)
    return H, E, bestH, bestI


def _finalize(bestH, bestI, qmask, jidx):
    """Reduce per-lane maxima to (score, target_end, query_end)."""
    bh = jnp.where(qmask, bestH, NEG)
    score = jnp.max(bh, axis=1)
    is_best = bh == score[:, None]
    big = jnp.float32(1e9)
    qend = jnp.min(jnp.where(is_best, jidx, big), axis=1)
    tend = jnp.min(jnp.where(is_best, bestI, big), axis=1)
    score = jnp.maximum(score, 0.0)
    none = score <= 0.0
    qend = jnp.where(none, 0.0, qend)
    tend = jnp.where(none, 0.0, tend)
    return score, tend.astype(jnp.int32), qend.astype(jnp.int32)


# ---------------------------------------------------------------------------
# Plain JAX implementation (the CPU route and the CUDA kernel's reference)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=('match', 'mismatch', 'fg', 'ext'))
def _sw_jax(q, t, qlens, tlens, *, match, mismatch, fg, ext):
    B, T = t.shape
    jidx = jnp.broadcast_to(jnp.arange(QP, dtype=jnp.float32)[None, :], (B, QP))
    qmask = jidx < qlens[:, None].astype(jnp.float32)

    q = q.astype(jnp.int32)
    subs_valid = q < 4

    def step(carry, inp):
        H, E, bestH, bestI = carry
        tcol, i = inp
        tcol = tcol[:, None]
        eq = (q == tcol) & subs_valid & (tcol < 4)
        s = jnp.where(eq, float(match), float(mismatch))
        s = jnp.where(qmask, s, NEG)
        tmask = (i < tlens)[:, None]
        H, E, bestH, bestI = _sw_step(
            H, E, bestH, bestI, s, jnp.float32(i), tmask, qmask, jidx,
            fg, ext)
        return (H, E, bestH, bestI), None

    zeros = jnp.zeros((B, QP), jnp.float32)
    init = (zeros, jnp.full((B, QP), NEG), jnp.full((B, QP), NEG), zeros)
    (H, E, bestH, bestI), _ = jax.lax.scan(
        step, init, (t.astype(jnp.int32).T, jnp.arange(T)), unroll=4)
    return _finalize(bestH, bestI, qmask, jidx)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def sw_max(queries, targets, qlens, tlens, scoring: ScoringConfig,
           backend: str | None = None):
    """Best local alignment of queries[b] vs targets[b] for every batch row.

    Args:
      queries: (B, <=128) uint8 codes (padded with 4/N).
      targets: (B, T) uint8 codes.
      qlens, tlens: (B,) int32 true lengths.
    Returns:
      (score f32, target_end i32, query_end i32), each (B,); end positions are
      0-based inclusive (ssw ``target_end_optimal`` convention); score 0 rows
      report ends of 0.
    """
    q = jnp.asarray(queries, jnp.uint8)
    t = jnp.asarray(targets, jnp.uint8)
    if q.shape[1] < QP:
        q = jnp.pad(q, [(0, 0), (0, QP - q.shape[1])], constant_values=4)
    kw = dict(match=float(scoring.match), mismatch=float(scoring.mismatch),
              fg=first_gap_cost(scoring), ext=float(scoring.gap_extend))
    qlens = jnp.asarray(qlens, jnp.int32)
    tlens = jnp.asarray(tlens, jnp.int32)
    fn = cuda.sw_max if cuda.kernel_route(backend) == 'cuda' else _sw_jax
    return fn(q, t, qlens, tlens, **kw)


@functools.partial(jax.jit, static_argnames=())
def _reverse_prefix(x, ends, pad_val):
    """out[b, i] = x[b, ends[b] - i] for i <= ends[b], else pad."""
    B, L = x.shape
    idx = ends[:, None] - jnp.arange(L)[None, :]
    valid = idx >= 0
    gathered = jnp.take_along_axis(x, jnp.clip(idx, 0, L - 1), axis=1)
    return jnp.where(valid, gathered, pad_val)


def sw_locate(queries, targets, qlens, tlens, scoring: ScoringConfig,
              backend: str | None = None):
    """Like :func:`sw_max` but also recovers alignment begins ssw-style:
    a second pass aligns reversed prefixes ending at the optimum
    (begin = end - reverse_end).  Returns dict of (B,) arrays:
    score, target_begin, target_end, query_begin, query_end.
    """
    q = jnp.asarray(queries, jnp.uint8)
    t = jnp.asarray(targets, jnp.uint8)
    score, tend, qend = sw_max(q, t, qlens, tlens, scoring, backend)
    rq = _reverse_prefix(q, qend, jnp.uint8(4))
    rt = _reverse_prefix(t, tend, jnp.uint8(4))
    rscore, rtend, rqend = sw_max(rq, rt, qend + 1, tend + 1, scoring, backend)
    none = score <= 0.0
    tbegin = jnp.where(none, 0, tend - rtend)
    qbegin = jnp.where(none, 0, qend - rqend)
    return {
        'score': score,
        'target_begin': tbegin.astype(jnp.int32),
        'target_end': tend.astype(jnp.int32),
        'query_begin': qbegin.astype(jnp.int32),
        'query_end': qend.astype(jnp.int32),
    }


# ---------------------------------------------------------------------------
# Lane-packed variant: several short queries per 128-lane row
# ---------------------------------------------------------------------------
#
# The concatemer scan aligns every ~21 bp primer (forward + revcomp)
# against the same 10 kb read window (filter_junk_from_fq.py:82-104
# semantics) — one row per primer wastes 107/128 lanes and re-streams the
# window per primer.  Here up to 128//stride primers pack into one row at
# fixed lane strides; segments are isolated inside the DP:
#
#   * the diagonal predecessor is reset to 0 at segment-start lanes
#     (each primer starts its own local alignment);
#   * the lane prefix-max that implements lazy-F gets + seg * SEG_BIG
#     added before and subtracted after, so a query-gap can never cross a
#     segment boundary (cross-segment contributions are -SEG_BIG lower).
#
# All DP values stay integer-valued and < 2^24, so f32 stays exact.
# Returns the row-global max — exactly the "any primer scores >= t"
# predicate the scan consumes.

SEG_BIG = 1.0e6


def _sw_step_packed(H, E, bestH, bestI, s, i_idx, tmask, lane_valid,
                    segf, seg_start, jidx, fg, ext):
    E = jnp.maximum(E - ext, H - fg)
    diag = _shift_right(H, 1, 0.0, jidx)
    diag = jnp.where(seg_start, 0.0, diag)
    Hno = jnp.maximum(jnp.maximum(diag + s, E), 0.0)
    Cm = _cummax_exclusive(Hno + jidx * ext + segf * SEG_BIG, jidx)
    F = Cm - segf * SEG_BIG - fg - (jidx - 1.0) * ext
    H = jnp.maximum(Hno, F)
    upd = (H > bestH) & tmask & lane_valid
    bestH = jnp.where(upd, H, bestH)
    bestI = jnp.where(upd, i_idx, bestI)
    return H, E, bestH, bestI


@functools.partial(jax.jit,
                   static_argnames=('match', 'mismatch', 'fg', 'ext',
                                    'stride'))
def _sw_packed_jax(q, t, tlens, *, match, mismatch, fg, ext, stride):
    B, T = t.shape
    jidx = jnp.broadcast_to(jnp.arange(QP, dtype=jnp.float32)[None, :],
                            (B, QP))
    segf = jnp.floor(jidx / float(stride))
    seg_start = jnp.mod(jidx, float(stride)) == 0.0
    q = q.astype(jnp.int32)
    lane_valid = q < 4

    def step(carry, inp):
        H, E, bestH, bestI = carry
        tcol, i = inp
        tcol = tcol[:, None]
        eq = (q == tcol) & lane_valid & (tcol < 4)
        s = jnp.where(eq, float(match), float(mismatch))
        s = jnp.where(lane_valid, s, NEG)
        tmask = (i < tlens)[:, None]
        H, E, bestH, bestI = _sw_step_packed(
            H, E, bestH, bestI, s, jnp.float32(i), tmask, lane_valid,
            segf, seg_start, jidx, fg, ext)
        return (H, E, bestH, bestI), None

    zeros = jnp.zeros((B, QP), jnp.float32)
    init = (zeros, jnp.full((B, QP), NEG), jnp.full((B, QP), NEG), zeros)
    (H, E, bestH, bestI), _ = jax.lax.scan(
        step, init, (t.astype(jnp.int32).T, jnp.arange(T)), unroll=4)
    return _finalize(bestH, bestI, lane_valid, jidx)


def pack_queries(code_lists, stride: int):
    """Pack short query code arrays into (n_rows, 128) at ``stride`` lane
    offsets.  Returns (rows uint8, row_of, lane_seg_of) where
    row_of[i]/lane_seg_of[i] locate query i."""
    per_row = QP // stride
    n_rows = (len(code_lists) + per_row - 1) // per_row
    rows = np.full((max(n_rows, 1), QP), 4, np.uint8)
    row_of = np.zeros(len(code_lists), np.int32)
    seg_of = np.zeros(len(code_lists), np.int32)
    for i, c in enumerate(code_lists):
        if len(c) > stride:
            raise ValueError(f'query {i} longer than stride {stride}')
        r, g = divmod(i, per_row)
        rows[r, g * stride:g * stride + len(c)] = c
        row_of[i] = r
        seg_of[i] = g
    return rows, row_of, seg_of


def sw_max_packed(queries, targets, tlens, scoring: ScoringConfig,
                  stride: int, backend: str | None = None):
    """Row-global best score over all packed queries vs targets[b].
    ``queries`` (B, 128) uint8 with one query per ``stride``-lane segment
    (pad 4).  Returns (score, target_end, lane_of_best)."""
    q = jnp.asarray(queries, jnp.uint8)
    t = jnp.asarray(targets, jnp.uint8)
    if q.shape[1] < QP:
        q = jnp.pad(q, [(0, 0), (0, QP - q.shape[1])], constant_values=4)
    kw = dict(match=float(scoring.match), mismatch=float(scoring.mismatch),
              fg=first_gap_cost(scoring), ext=float(scoring.gap_extend),
              stride=stride)
    tlens = jnp.asarray(tlens, jnp.int32)
    fn = (cuda.sw_max_packed if cuda.kernel_route(backend) == 'cuda'
          else _sw_packed_jax)
    return fn(q, t, tlens, **kw)
