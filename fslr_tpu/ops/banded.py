"""Banded affine-gap Smith-Waterman extension kernel.

The extension half of the bwa-mem replacement (/root/reference/fslr/main.py:125
scoring -A2 -B3 -O5 -E2): each candidate diagonal band from ops/seed.py is
extended by a local alignment of the full read against a reference window,
restricted to a diagonal band of width BW = 128 lanes.

Layout: band offsets l = 0..BW-1 live on lanes; query positions i are
scanned sequentially; candidates are rows.  Cell (i, l) covers
reference position  ws + i + l  where ws is the window's global start
(= anchor_diag - BW/2).  Predecessors:

  diagonal (i-1, j-1): same lane;
  query-gap (i-1, j):  lane l+1 (shift left, NEG beyond the band);
  ref-gap   (i, j-1):  lane l-1 — the in-row dependency, handled with the
                       same lane prefix-max closed form as ops/ssw.py.

Two implementations share this recurrence: the plain ``lax.scan`` below
(the CPU route and the reference) and the CUDA kernel of ops/cuda.py.

Outputs per row: best score, query end step i*, band lane l* (both 0-based
inclusive); rend = ws + i* + l*.  Begins are recovered by a second pass on
reversed prefixes (see stages/align.py for the coordinate algebra).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fslr_tpu.config import ScoringConfig
from fslr_tpu.ops import cuda
from fslr_tpu.ops.ssw import NEG, _cummax_exclusive, first_gap_cost

BW = 128          # band width (lanes)


def _banded_step(H, E, bestH, bestI, s, i_idx, qmask_i, jidx, fg, ext):
    """One query row.  All arrays (N, BW) f32; qmask_i is scalar-per-row."""
    # query-gap (vertical in band space): predecessor at lane l+1
    H_up = _shift_left(H, jidx)
    E_up = _shift_left(E, jidx)
    E = jnp.maximum(E_up - ext, H_up - fg)
    Hno = jnp.maximum(jnp.maximum(H + s, E), 0.0)   # diag: same lane
    Cm = _cummax_exclusive(Hno + jidx * ext, jidx)
    F = Cm - fg - (jidx - 1.0) * ext
    Hnew = jnp.maximum(Hno, F)
    upd = (Hnew > bestH) & qmask_i
    bestH = jnp.where(upd, Hnew, bestH)
    bestI = jnp.where(upd, i_idx, bestI)
    return Hnew, E, bestH, bestI


def _shift_left(x, jidx):
    """x[l] -> x[l+1]; lane BW-1 becomes NEG (outside the band)."""
    return jnp.where(jidx < BW - 1, jnp.roll(x, BW - 1, axis=1), NEG)


# ---------------------------------------------------------------------------
# Word-packed code gathers: int32 WORDS (4 codes each) are gathered and
# byte-extracted with vector shifts, a quarter of the gather indices of a
# per-element uint8 gather.  Sources are packed little-endian (code i ->
# byte i % 4 of word i // 4); codes are <= 4 so words are never negative
# and arithmetic shifts are safe.
# ---------------------------------------------------------------------------

def pack_codes_host(u8: "np.ndarray"):
    """Host packing: (G,) uint8 codes -> (ceil(G/4),) int32 words
    (little-endian), pad bytes = 4 (the N code)."""
    import numpy as np
    pad = (-len(u8)) % 4
    a = np.pad(u8, (0, pad), constant_values=4)
    return a.view('<i4') if a.flags['C_CONTIGUOUS'] else         np.ascontiguousarray(a).view('<i4')


def pack_codes_device(u8):
    """Device packing of a (..., L) uint8 code array along the last axis
    (L % 4 == 0) -> (..., L // 4) int32 words."""
    a = u8.astype(jnp.int32).reshape(u8.shape[:-1] + (-1, 4))
    return (a[..., 0] | (a[..., 1] << 8) | (a[..., 2] << 16)
            | (a[..., 3] << 24))


def gather_stream(src32, start, L: int):
    """(N, L) int32 byte stream  out[r, j] = src[start[r] + j]  from a
    word-packed source.  No validity masking (callers mask by position);
    out-of-range reads clip to the source and return pad codes."""
    w0 = start >> 2                     # arithmetic shift = floor division
    a = start & 3
    nw = L // 4 + 1
    widx = jnp.clip(w0[:, None] + jnp.arange(nw, dtype=jnp.int32)[None, :],
                    0, src32.shape[0] - 1)
    W = jnp.take(src32, widx)           # (N, nw)
    sh = (jnp.arange(4, dtype=jnp.int32) * 8)[None, None, :]
    B = ((W[:, :, None] >> sh) & 255).reshape(W.shape[0], nw * 4)
    aa = a[:, None]
    return jnp.where(
        aa == 0, B[:, 0:L],
        jnp.where(aa == 1, B[:, 1:L + 1],
                  jnp.where(aa == 2, B[:, 2:L + 2], B[:, 3:L + 3])))


def gather_stream_rows(rows32, start, L: int):
    """Per-row variant: out[r, j] = rows[r, 4*w + b] byte stream starting
    at in-row byte offset start[r] (clipped to the row)."""
    w0 = start >> 2
    a = start & 3
    nw = L // 4 + 1
    widx = jnp.clip(w0[:, None] + jnp.arange(nw, dtype=jnp.int32)[None, :],
                    0, rows32.shape[1] - 1)
    W = jnp.take_along_axis(rows32, widx, axis=1)
    sh = (jnp.arange(4, dtype=jnp.int32) * 8)[None, None, :]
    B = ((W[:, :, None] >> sh) & 255).reshape(W.shape[0], nw * 4)
    aa = a[:, None]
    return jnp.where(
        aa == 0, B[:, 0:L],
        jnp.where(aa == 1, B[:, 1:L + 1],
                  jnp.where(aa == 2, B[:, 2:L + 2], B[:, 3:L + 3])))


# ---------------------------------------------------------------------------
# Score-only extension (forward + reverse pass): the path over ALL
# candidates.  Emitting traceback codes costs far more than scoring, so
# candidates only pay the emit cost AFTER selection (stages/align.py runs
# the emit kernel on the dodi-selected winners only — typically ~15% of
# candidates).
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=('match', 'mismatch', 'fg',
                                             'ext', 'WL', 'route'))
def _score_extend_impl(q, qlens, ws, cmin, cmax, genome32, *, match,
                       mismatch, fg, ext, WL, route):
    """Window gather + forward banded SW (ends) + reverse banded SW
    (begins), one jit, nothing but a (N, 5) int32 result to fetch.

    ``genome32`` is the word-packed genome (pack_codes_host); all windows
    and the reversed query are built with word gathers + vector byte
    extraction (see gather_stream).

    Reverse-pass geometry: a forward path ends at query i* = qend with the
    band cell covering ref position  re = ws + i* + l*.  Reversing both
    sequences around that end maps forward band cell (i, l) onto reverse
    cell (j, l2) = (i* - i, BW-1 - l): with the reversed window read
    wr[t] = genome[rstart0 - t] anchored at  rstart0 = ws + qend + BW - 1
    (independent of l*), the reverse diag offset is l2 = BW-1 - l, which
    covers [0, BW) exactly.  The reverse best end (jend, lane_r) then
    gives  qstart = qend - jend  and the begin lane  l_fin = BW-1 - lane_r
    (rbegin = ws + qstart + l_fin).  Affine gap scores are invariant under
    reversal, so the reverse best score equals the forward score; on
    co-optimal ties the reverse pass may pick a different (equally
    optimal) begin than a traceback walk would — selected alignments get
    their begins re-derived from the real walk (stages/align.py), so
    artifacts never see the difference.
    """
    GB = genome32.shape[0] * 4       # incl. <=3 pad bytes of code 4
    tt = jnp.arange(WL, dtype=jnp.int32)[None, :]
    idx = ws[:, None] + tt
    valid = (idx >= cmin[:, None]) & (idx < cmax[:, None]) \
        & (idx >= 0) & (idx < GB)
    w = jnp.where(valid, gather_stream(genome32, ws, WL), 4)
    kw = dict(match=match, mismatch=mismatch, fg=fg, ext=ext)
    fb = cuda.banded_score if route == 'cuda' else _banded_jax
    score, qend, lane = fb(q, w, qlens, **kw)

    SL = q.shape[1]
    jar = jnp.arange(SL, dtype=jnp.int32)[None, :]
    q32 = pack_codes_device(q)
    # qrev[j] = q[qend - j]: forward stream from qend-(SL-1), flipped
    qr_stream = gather_stream_rows(q32, qend - (SL - 1), SL)[:, ::-1]
    qidx = qend[:, None] - jar
    qr = jnp.where(qidx >= 0, qr_stream, 4)
    rstart0 = ws + qend + (BW - 1)
    ridx = rstart0[:, None] - tt
    rvalid = (ridx >= cmin[:, None]) & (ridx < cmax[:, None]) \
        & (ridx >= 0) & (ridx < GB)
    wr_stream = gather_stream(genome32, rstart0 - (WL - 1), WL)[:, ::-1]
    wr = jnp.where(rvalid, wr_stream, 4)
    _score_r, jend, lane_r = fb(qr, wr, qend + 1, **kw)
    qstart = qend - jend
    l_fin = (BW - 1) - lane_r
    return jnp.stack([score.astype(jnp.int32), qend, lane, qstart, l_fin])


def banded_extend_score(q, qlens, ws, cmin, cmax, genome_dev,
                        scoring: ScoringConfig, backend: str | None = None):
    """Score-only extension against device-resident genome windows.

    Args: q (N, SL) uint8 read-slice codes; ws/cmin/cmax (N,) int32 global
    window starts and contig bounds; genome_dev: word-packed int32 genome
    (pack_codes_host).
    Returns a device (5, N) int32 array [score, qend, lane, qstart,
    l_fin] (ends/begins 0-based inclusive; rbegin = ws + qstart + l_fin,
    rend = ws + qend + lane).  Fetch after all dispatches.
    """
    kw = dict(match=float(scoring.match), mismatch=float(scoring.mismatch),
              fg=first_gap_cost(scoring), ext=float(scoring.gap_extend),
              WL=q.shape[1] + 256, route=cuda.kernel_route(backend))
    return _score_extend_impl(
        jnp.asarray(q), jnp.asarray(qlens, jnp.int32),
        jnp.asarray(ws, jnp.int32), jnp.asarray(cmin, jnp.int32),
        jnp.asarray(cmax, jnp.int32), genome_dev, **kw)


# ---------------------------------------------------------------------------
# Plain JAX implementation (the CPU route and the CUDA kernel's reference)
# ---------------------------------------------------------------------------

def window_codes(w, i, qcol, match, mismatch):
    """Substitution scores of query step i: window[:, i:i+BW] vs the query
    base ``qcol`` (N,), sliced inside the step (no (Lq, N, BW) window
    stack is ever materialised)."""
    wsl = jax.lax.dynamic_slice_in_dim(w, i, BW, axis=1)
    eq = (wsl == qcol[:, None]) & (qcol[:, None] < 4) & (wsl < 4)
    return jnp.where(eq, float(match), float(mismatch))


@functools.partial(jax.jit, static_argnames=('match', 'mismatch', 'fg', 'ext'))
def _banded_jax(q, w, qlens, *, match, mismatch, fg, ext):
    q = q.astype(jnp.int32)
    w = w.astype(jnp.int32)
    N, Lq = q.shape
    jidx = jnp.broadcast_to(
        jnp.arange(BW, dtype=jnp.float32)[None, :], (N, BW))

    def step(carry, inp):
        H, E, bestH, bestI = carry
        qcol, i = inp
        s = window_codes(w, i, qcol, match, mismatch)
        qmask_i = (i < qlens)[:, None]
        H, E, bestH, bestI = _banded_step(
            H, E, bestH, bestI, s, jnp.float32(i), qmask_i, jidx, fg, ext)
        return (H, E, bestH, bestI), None

    zeros = jnp.zeros((N, BW), jnp.float32)
    init = (zeros, jnp.full((N, BW), NEG), jnp.full((N, BW), NEG), zeros)
    (H, E, bestH, bestI), _ = jax.lax.scan(
        step, init, (q.T, jnp.arange(Lq)), unroll=4)
    score = jnp.max(bestH, axis=1)
    is_best = bestH == score[:, None]
    big = jnp.float32(1e9)
    lane = jnp.min(jnp.where(is_best, jidx, big), axis=1)
    qend = jnp.min(jnp.where(is_best, bestI, big), axis=1)
    score = jnp.maximum(score, 0.0)
    none = score <= 0.0
    return (score, jnp.where(none, 0, qend).astype(jnp.int32),
            jnp.where(none, 0, lane).astype(jnp.int32))


def banded_sw(q, w, qlens, scoring: ScoringConfig, backend: str | None = None):
    """Best banded local alignment per row.  q (N, Lq) codes, w (N, Lq+256)
    window codes.  Returns (score, qend, lane), ends 0-based inclusive."""
    kw = dict(match=float(scoring.match), mismatch=float(scoring.mismatch),
              fg=first_gap_cost(scoring), ext=float(scoring.gap_extend))
    q = jnp.asarray(q)
    w = jnp.asarray(w)
    qlens = jnp.asarray(qlens, jnp.int32)
    fn = cuda.banded_score if cuda.kernel_route(backend) == 'cuda' \
        else _banded_jax
    return fn(q, w, qlens, **kw)
