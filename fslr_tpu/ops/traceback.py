"""Banded SW with traceback: direction-bit emission + lockstep path walk.

Extends ops/banded.py with per-cell 4-bit traceback codes so selected
alignments get real per-base paths (CIGARs for the BAM artifact, pileup
columns for the consensus stage) without any per-read host DP:

  bits 0-1  H source: 0 = local start, 1 = diagonal, 2 = E (query gap /
            insertion), 3 = F (reference gap / deletion)
  bit 2     E extends a previous E (vs opening from H)
  bit 3     F extends a previous F (vs opening from H)

Codes for 8 consecutive query steps are packed into one int32 word
(code << 4*(i % 8)), giving a (N, Lq/8, BW) output — 64 KB per 2048-bp
row.  The path walk advances every active alignment one traceback step
per iteration (O(path length) iterations total): on the device for the
pipeline (_walk_device, or the CUDA walk of ops/cuda.py), in numpy for
the consensus pileup (walk_paths).

Ties prefer diagonal moves, then E, then F — any optimal-path tie-break is
valid; this one favours matches, which is what CIGAR consumers expect.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from fslr_tpu.config import ScoringConfig
from fslr_tpu.ops import cuda
from fslr_tpu.ops.ssw import NEG, _cummax_exclusive, _shift_right, \
    first_gap_cost
from fslr_tpu.ops.banded import BW, _shift_left, window_codes


def _tb_step(H, E, s, jidx, fg, ext):
    """One query row; returns (H, E, code) with code (N, BW) int32."""
    H_up = _shift_left(H, jidx)
    E_up = _shift_left(E, jidx)
    e_ext = (E_up - ext) >= (H_up - fg)
    E = jnp.maximum(E_up - ext, H_up - fg)
    diag = H + s
    Hno = jnp.maximum(jnp.maximum(diag, E), 0.0)
    C = Hno + jidx * ext
    Cm = _cummax_exclusive(C, jidx)
    F = Cm - fg - (jidx - 1.0) * ext
    # F opened at lane l-1 iff the prefix max is achieved by C[l-1]
    C_prev = _shift_right(C, 1, NEG, jidx)
    f_ext = Cm > C_prev
    Hnew = jnp.maximum(Hno, F)
    is_f = F > Hno
    src = jnp.where(is_f, 3,
                    jnp.where((diag == Hno) & (Hno > 0.0), 1,
                              jnp.where((E == Hno) & (Hno > 0.0), 2, 0)))
    code = (src + jnp.where(e_ext, 4, 0) + jnp.where(f_ext, 8, 0)) \
        .astype(jnp.int32)
    return Hnew, E, code


@functools.partial(jax.jit, static_argnames=('match', 'mismatch', 'fg',
                                             'ext'))
def _tb_jax(q, w, qlens, *, match, mismatch, fg, ext):
    """Plain banded SW emitting traceback codes.  The scan runs over
    groups of 8 query steps and emits one packed code word per group, so
    only the (Lq/8, N, BW) bits tensor is ever stacked."""
    q = q.astype(jnp.int32)
    w = w.astype(jnp.int32)
    N, Lq = q.shape
    assert Lq % 8 == 0
    jidx = jnp.broadcast_to(jnp.arange(BW, dtype=jnp.float32)[None, :],
                            (N, BW))

    def group(carry, inp):
        H, E, bestH, bestI = carry
        qg, r = inp                       # (8, N) query codes of group r
        pack = jnp.zeros((N, BW), jnp.int32)
        for sub in range(8):
            i = r * 8 + sub
            s = window_codes(w, i, qg[sub], match, mismatch)
            H, E, code = _tb_step(H, E, s, jidx, fg, ext)
            upd = (H > bestH) & ((i < qlens)[:, None])
            bestH = jnp.where(upd, H, bestH)
            bestI = jnp.where(upd, i.astype(jnp.float32), bestI)
            pack = pack | (code << (4 * sub))
        return (H, E, bestH, bestI), pack

    zeros = jnp.zeros((N, BW), jnp.float32)
    init = (zeros, jnp.full((N, BW), NEG), jnp.full((N, BW), NEG), zeros)
    qg = q.T.reshape(Lq // 8, 8, N)
    (H, E, bestH, bestI), packs = jax.lax.scan(
        group, init, (qg, jnp.arange(Lq // 8)))
    bits = jnp.transpose(packs, (1, 0, 2))          # (N, Lq/8, BW)
    score = jnp.max(bestH, axis=1)
    is_best = bestH == score[:, None]
    big = jnp.float32(1e9)
    lane = jnp.min(jnp.where(is_best, jidx, big), axis=1)
    qend = jnp.min(jnp.where(is_best, bestI, big), axis=1)
    score = jnp.maximum(score, 0.0)
    none = score <= 0.0
    return (score, jnp.where(none, 0, qend).astype(jnp.int32),
            jnp.where(none, 0, lane).astype(jnp.int32), bits)


def banded_sw_tb(q, w, qlens, scoring: ScoringConfig):
    """Banded SW emitting traceback bits (plain path; the bits tensor is
    the consensus pileup's input).  Returns (score, qend, lane, bits) with
    bits (N, Lq//8, BW) int32; Lq must be a multiple of 8."""
    kw = dict(match=float(scoring.match), mismatch=float(scoring.mismatch),
              fg=first_gap_cost(scoring), ext=float(scoring.gap_extend))
    return _tb_jax(jnp.asarray(q), jnp.asarray(w),
                   jnp.asarray(qlens, jnp.int32), **kw)


# ---------------------------------------------------------------------------
# Lockstep path walk — device version (only ~T/4 bytes per alignment leave
# the device) and a host/numpy version (the consensus pileup's walk).
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=('T',))
def _walk_device(bits, qend, lane, T):
    """Vectorized traceback on device.  bits (N, R, BW) int32.

    Returns (emits (N, T) uint8 [255 = no emit, else OP_M/I/D], n_ops,
    i_fin, l_fin) — the emit stream is sparse in step order (end->start);
    use cigars_from_emits to compact + RLE.
    """
    N, R, BW_ = bits.shape
    Lq = R * 8
    # per-row gather: index space is R*BW (< 2^31 always), NOT N*R*BW —
    # a flat int32 index overflows for large winner batches (1M-read
    # chunks put ~1e10 words in the flat view)
    flat2 = bits.reshape(N, R * BW_)

    def step(carry, _):
        i, l, st, active = carry
        ii = jnp.clip(i, 0, Lq - 1)
        ll = jnp.clip(l, 0, BW_ - 1)
        word = jnp.take_along_axis(
            flat2, ((ii >> 3) * BW_ + ll)[:, None], axis=1)[:, 0]
        code = (word >> ((ii & 7) * 4)) & 15
        src = code & 3
        e_ext = (code & 4) != 0
        f_ext = (code & 8) != 0
        is_h = active & (st == 0)
        stop = is_h & (src == 0)
        diag = is_h & (src == 1)
        to_e = is_h & (src == 2)
        to_f = is_h & (src == 3)
        in_e = active & (st == 1)
        in_f = active & (st == 2)
        emit = jnp.where(diag, OP_M,
                         jnp.where(in_e, OP_I,
                                   jnp.where(in_f, OP_D, 255)))
        emit = emit.astype(jnp.uint8)
        st = jnp.where(to_e, 1, jnp.where(to_f, 2, st))
        st = jnp.where((in_e & ~e_ext) | (in_f & ~f_ext), 0, st)
        i = i - (diag | in_e).astype(jnp.int32)
        l = l + in_e.astype(jnp.int32) - in_f.astype(jnp.int32)
        active = active & ~stop & (i >= 0)
        return (i, l, st, active), emit

    init = (qend.astype(jnp.int32), lane.astype(jnp.int32),
            jnp.zeros(N, jnp.int8), jnp.ones(N, jnp.bool_))
    (i, l, st, active), emits = jax.lax.scan(step, init, None, length=T)
    emits = emits.T                       # (N, T)
    n_ops = jnp.sum(emits != 255, axis=1)
    return emits, n_ops, i, l


def cigars_from_emits(emits: np.ndarray, i_fin, l_fin):
    """Compact sparse end->start emit streams into per-row CIGAR tuples
    (start->end order), fully vectorized until the tiny per-run loop."""
    N, T = emits.shape
    rows_idx, cols_idx = np.nonzero(emits != 255)
    codes = emits[rows_idx, cols_idx]
    if len(codes) == 0:
        return [[] for _ in range(N)], np.asarray(i_fin) + 1, np.asarray(
            l_fin)
    brk = np.empty(len(codes), bool)
    brk[0] = True
    brk[1:] = (rows_idx[1:] != rows_idx[:-1]) | (codes[1:] != codes[:-1])
    starts = np.nonzero(brk)[0]
    lengths = np.diff(np.append(starts, len(codes)))
    run_rows = rows_idx[starts]
    run_codes = codes[starts]
    row_breaks = np.searchsorted(run_rows, np.arange(N + 1))
    cigars = []
    for r in range(N):
        lo, hi = row_breaks[r], row_breaks[r + 1]
        cig = [(int(lengths[k]), _OP_CHARS[run_codes[k]])
               for k in range(hi - 1, lo - 1, -1)]     # reverse: end->start
        cigars.append(cig)
    return cigars, np.asarray(i_fin) + 1, np.asarray(l_fin)


@functools.partial(jax.jit, static_argnames=('match', 'mismatch', 'fg',
                                             'ext', 'WL', 'route'))
def _extend_walk_impl(q, qlens, ws, cmin, cmax, genome, *, match, mismatch,
                      fg, ext, WL, route):
    """Window gather + banded traceback extension + device walk, one jit.

    Reference windows are gathered from the device-resident genome (no
    window upload), and all small results come back as ONE packed int32
    array; only the compact emit stream is a second transfer.
    """
    from fslr_tpu.ops.banded import gather_stream
    GB = genome.shape[0] * 4         # word-packed; <=3 pad bytes code 4
    idx = ws[:, None] + jnp.arange(WL, dtype=jnp.int32)[None, :]
    valid = (idx >= cmin[:, None]) & (idx < cmax[:, None]) \
        & (idx >= 0) & (idx < GB)
    w = jnp.where(valid, gather_stream(genome, ws, WL), 4)
    return extend_windows(q, w, qlens, match=match, mismatch=mismatch,
                          fg=fg, ext=ext, route=route)


def extend_windows(q, w, qlens, *, match, mismatch, fg, ext, route):
    """Traceback emit + path walk over explicit (N, Lq + 256) windows:
    (packed (6, N) int32 [score, qend, lane, qstart, l_fin, n_ops],
    emits (N, (Lq + BW) / 4) uint8), by the CUDA kernel or the plain
    path."""
    kw = dict(match=match, mismatch=mismatch, fg=fg, ext=ext)
    if route == 'cuda':
        return cuda.banded_extend(q, w, qlens, **kw)
    return walk_packed(*_tb_jax(q, w, qlens, **kw))


def walk_packed(score, qend, lane, bits):
    """Device walk of a bits tensor, results packed for one fetch: the
    (6, N) int32 ends/begins array and the 2-bit emit stream (codes
    0/1/2 = M/I/D, 3 = none; 4x less traffic than bytes)."""
    T = bits.shape[1] * 8 + bits.shape[2]
    emits, n_ops, i_fin, l_fin = _walk_device(bits, qend, lane, T)
    packed = jnp.stack([score.astype(jnp.int32), qend, lane,
                        i_fin + 1, l_fin, n_ops.astype(jnp.int32)])
    N = emits.shape[0]
    e2 = jnp.where(emits == 255, 3, emits).astype(jnp.int32)
    e2 = e2.reshape(N, T // 4, 4)
    weights = jnp.array([1, 4, 16, 64], jnp.int32)
    emits_packed = jnp.sum(e2 * weights[None, None, :],
                           axis=2).astype(jnp.uint8)
    return packed, emits_packed


def banded_extend(q, qlens, ws, cmin, cmax, genome_dev,
                  scoring: ScoringConfig, backend: str | None = None):
    """Extension + traceback against device-resident genome windows.

    Args: q (N, SL) uint8 read-slice codes; ws/cmin/cmax (N,) int32 global
    window starts and contig bounds; genome_dev: word-packed int32 genome
    (ops/banded.pack_codes_host).
    Returns (score, qend, lane, qstart, l_fin, cigars) numpy/host values.
    """
    kw = dict(match=float(scoring.match), mismatch=float(scoring.mismatch),
              fg=first_gap_cost(scoring), ext=float(scoring.gap_extend),
              WL=q.shape[1] + 256, route=cuda.kernel_route(backend))
    packed, emits = _extend_walk_impl(
        jnp.asarray(q), jnp.asarray(qlens, jnp.int32),
        jnp.asarray(ws, jnp.int32), jnp.asarray(cmin, jnp.int32),
        jnp.asarray(cmax, jnp.int32), genome_dev, **kw)
    return packed, emits          # still on device; finalize with
                                  # finalize_extend after all dispatches


def finalize_extend(packed, emits_packed):
    p = np.asarray(packed)
    score, qend, lane, qstart, l_fin, n_ops = p
    ep = np.asarray(emits_packed)
    N, T4 = ep.shape
    e = ((ep[:, :, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3)
    e = e.reshape(N, T4 * 4).astype(np.uint8)
    e[e == 3] = 255
    cigars, qs2, lf2 = cigars_from_emits(e, qstart - 1, l_fin)
    return score, qend, lane, qstart, l_fin, cigars


# ---------------------------------------------------------------------------
# Host walker (numpy)
# ---------------------------------------------------------------------------

# op codes emitted by the walk
OP_M, OP_I, OP_D = 0, 1, 2
_OP_CHARS = 'MID'


def walk_paths(bits: np.ndarray, qend: np.ndarray, lane: np.ndarray,
               max_steps: int | None = None):
    """Trace back all alignments in lockstep.

    Args:
      bits: (N, Lq//8, BW) int32 packed codes.
      qend, lane: (N,) end cell per alignment.
    Returns:
      ops: (N, T) uint8 op codes (OP_M/I/D), emitted end->start, padded 255;
      n_ops: (N,) number of valid steps;
      qstart, lstart: (N,) start cell of each path.
    """
    bits = np.asarray(bits)
    N = bits.shape[0]
    Lq = bits.shape[1] * 8
    if max_steps is None:
        max_steps = Lq + BW
    i = np.asarray(qend).astype(np.int64).copy()
    l = np.asarray(lane).astype(np.int64).copy()
    state = np.zeros(N, np.int8)          # 0=H, 1=E, 2=F
    active = np.ones(N, bool)
    ops = np.full((N, max_steps), 255, np.uint8)
    n_ops = np.zeros(N, np.int64)
    rows = np.arange(N)
    for step in range(max_steps):
        if not active.any():
            break
        ii = np.clip(i, 0, Lq - 1)
        ll = np.clip(l, 0, BW - 1)
        word = bits[rows, ii >> 3, ll]
        code = (word >> ((ii & 7) * 4)) & 15
        src = code & 3
        e_ext = (code & 4) != 0
        f_ext = (code & 8) != 0

        is_h = active & (state == 0)
        stop = is_h & (src == 0)
        diag = is_h & (src == 1)
        to_e = is_h & (src == 2)
        to_f = is_h & (src == 3)
        in_e = active & (state == 1)
        in_f = active & (state == 2)

        emit = np.full(N, 255, np.uint8)
        emit[diag] = OP_M
        emit[in_e] = OP_I
        emit[in_f] = OP_D
        do_emit = emit != 255
        ops[rows[do_emit], n_ops[do_emit]] = emit[do_emit]
        n_ops[do_emit] += 1

        # transitions
        state[to_e] = 1
        state[to_f] = 2
        # moves for cells just consumed
        i[diag] -= 1                      # lane unchanged
        i[in_e] -= 1
        l[in_e] += 1
        l[in_f] -= 1
        # gap state continuation decided by the consumed cell's ext bit
        back_h_e = in_e & ~e_ext
        back_h_f = in_f & ~f_ext
        state[back_h_e | back_h_f] = 0
        active = active & ~stop & (i >= -1)
        # a path that walked past row 0 is complete
        active &= i >= 0
    return ops, n_ops, i, l


def ops_to_cigar(ops_row: np.ndarray, n: int) -> list[tuple[int, str]]:
    """Run-length encode one reversed op row into CIGAR tuples
    (start->end order)."""
    if n == 0:
        return []
    seq = ops_row[:n][::-1]
    out = []
    prev = int(seq[0])
    run = 1
    for v in seq[1:]:
        v = int(v)
        if v == prev:
            run += 1
        else:
            out.append((run, _OP_CHARS[prev]))
            prev = v
            run = 1
    out.append((run, _OP_CHARS[prev]))
    return out


def finalize_scores(packed):
    """Score/end/begin columns of a fetched ``packed`` array without
    decoding emit streams (CIGARs decode lazily per selected row with
    :func:`decode_emit_row` — most extension candidates lose selection
    and never need one)."""
    p = np.asarray(packed)
    return p[0], p[1], p[2], p[3], p[4]


# Byte-level boundary LUTs for decode_emit_rle: a packed byte holds 4
# codes; only bytes with an internal code change, or whose first code
# differs from the previous byte's last code, can contain a run boundary
# (~10 per row vs ~1000 codes), so the per-code expansion happens only at
# those bytes.
_B_CODES = (((np.arange(256, dtype=np.uint16)[:, None]
              >> np.array([0, 2, 4, 6])) & 3).astype(np.uint8))   # (256,4)
_B_FIRST = _B_CODES[:, 0].copy()
_B_LAST = _B_CODES[:, 3].copy()
_B_INT_BRK = (_B_CODES[:, 1:] != _B_CODES[:, :-1]).any(axis=1)


def decode_emit_rle(blocks: np.ndarray):
    """Columnar RLE of a (n, t4) block of 2-bit-packed emit rows:
    (seg_row, seg_len, seg_op) numpy arrays in row order, op codes
    0/1/2 = M/I/D (BAM op numbering).

    Boundary detection is byte-granular (LUTs above): only candidate
    bytes are expanded to codes — the previous per-op expansion
    (np.nonzero over every M/I/D step) materialized ~1 GB of
    freshly-paged intermediates per 30k-alignment block and cost ~3 s
    of the 10k-read align stage.  "none" codes (3) form their own runs,
    are dropped, and adjacent same-op runs they separated are merged —
    in walk-produced streams a none only ever sits at a gap open
    (between different ops), but the merge keeps this exact for
    arbitrary blocks too (tests/test_traceback.py feeds random ones)."""
    n = len(blocks)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    t4 = blocks.shape[1]
    T = t4 * 4
    first = _B_FIRST[blocks]               # (n, t4)
    last = _B_LAST[blocks]
    prev_last = np.empty_like(last)
    prev_last[:, 0] = 255                  # row start: always a boundary
    prev_last[:, 1:] = last[:, :-1]
    cand = _B_INT_BRK[blocks] | (first != prev_last)
    rr_b, bb = np.nonzero(cand)            # candidate bytes, row-major
    codes4 = _B_CODES[blocks[rr_b, bb]]    # (m, 4)
    prevs = np.concatenate([prev_last[rr_b, bb][:, None],
                            codes4[:, :3]], axis=1)
    is_brk = codes4 != prevs               # (m, 4)
    mr, mo = np.nonzero(is_brk)            # still row-major, t ascending
    rr = rr_b[mr]
    tt = bb[mr] * 4 + mo
    flat = rr * np.int64(T) + tt
    lengths = np.diff(np.append(flat, n * np.int64(T)))
    vals = codes4[mr, mo]
    keep = vals != 3
    rr, tt = rr[keep], tt[keep]
    lengths, vals = lengths[keep], vals[keep]
    if not len(vals):
        z = np.zeros(0, np.int64)
        return z, z, z
    # emitted order is end->start: reverse run order within each row
    ordr = np.lexsort((-tt, rr))
    rr, lengths, vals = rr[ordr], lengths[ordr], vals[ordr]
    # merge adjacent same-op runs separated only by dropped none-runs
    new_seg = np.ones(len(vals), bool)
    new_seg[1:] = (rr[1:] != rr[:-1]) | (vals[1:] != vals[:-1])
    starts = np.flatnonzero(new_seg)
    seg_len = np.add.reduceat(lengths, starts)
    return (rr[starts].astype(np.int64), seg_len.astype(np.int64),
            vals[starts].astype(np.int64))


def decode_emit_rows(blocks: np.ndarray) -> list[list[tuple[int, str]]]:
    """CIGARs of a whole (n, t4) block of 2-bit-packed emit rows in one
    vectorized pass (per-row decode_emit_row calls cost ~0.5 s per 30k
    selected alignments)."""
    out: list[list] = [[] for _ in range(len(blocks))]
    seg_rows, seg_len, seg_ops = decode_emit_rle(blocks)
    for r, ln, op in zip(seg_rows.tolist(), seg_len.tolist(),
                         seg_ops.tolist()):
        out[r].append((int(ln), _OP_CHARS[op]))
    return out


def decode_emit_row(ep_row: np.ndarray) -> list[tuple[int, str]]:
    """CIGAR of one 2-bit-packed emit row (codes 0/1/2 = M/I/D, 3 = none,
    emitted end->start)."""
    e = ((ep_row[:, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3)
    e = e.reshape(-1)
    seq = e[e != 3][::-1]
    if len(seq) == 0:
        return []
    brk = np.nonzero(np.diff(seq))[0]
    starts = np.concatenate([[0], brk + 1])
    ends = np.concatenate([brk + 1, [len(seq)]])
    return [(int(e_ - s_), _OP_CHARS[seq[s_]])
            for s_, e_ in zip(starts, ends)]
