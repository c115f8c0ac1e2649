"""Read-to-profile banded alignment with traceback — the POA core kernel.

Replaces abpoa's read-to-graph DP (/root/reference/fslr/consensus_seq.py:32-37).
The partial-order graph is kept in *column-merged* form: one column per
topological rank, per-column base counts (aligned nodes of a rank share a
column, as in abpoa's consensus bundling).  Aligning a read to that graph
is then a banded affine DP against a position-specific score profile:

  * substitution score  s(b, c)  = count-weighted match/mismatch of read
    base b against column c's base distribution (profile alignment);
  * deleting column c costs a per-column gap-extend  ext_c = E * cov(c),
    so columns supported by a minority (insertions of a few reads) are
    nearly free to skip — exactly the POA bypass-edge semantics.

The kernel runs as a plain ``lax.scan`` (it is off the main path: the
opt-in consensus stage).  Layout matches ops/banded.py: lanes = band
offsets over profile columns,
query rows scanned sequentially, 4-bit traceback codes (ops/traceback.py
conventions) packed 8/word.  The per-column gap costs generalize the
lazy-F lane prefix-max: with cumulative costs  g[c] = sum_{m<=c} ext_m,

  F[l] = max_{k<l} (H[k] + g[k]) - openF - g[l]

which is still an (exclusive) lane prefix-max, now of  H + g.

Per-column scores ship as ONE int32 plane (4 x int8 fixed-point, x16):
each step extracts the read-base byte with a per-row variable shift.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from fslr_tpu.config import ScoringConfig
from fslr_tpu.ops.ssw import NEG, _cummax_exclusive, _shift_right, \
    first_gap_cost
from fslr_tpu.ops.banded import BW, _shift_left
from fslr_tpu.ops import traceback as tb

SCALE = 16.0          # fixed-point scale of the packed int8 scores
PAD_BYTE = -128       # packed score for out-of-profile columns (-8.0)
PAD_WORD_I32 = 0x80808080 - (1 << 32)    # 4 x PAD_BYTE as an int32


def _prof_tb_step(H, E, s, g, jidx, fg, ext, openF):
    """One query row with per-column deletion costs.

    s: (N, BW) substitution scores; g: (N, BW) cumulative per-column
    gap-extend costs (global offsets cancel).  Returns (H, E, code)."""
    H_up = _shift_left(H, jidx)
    E_up = _shift_left(E, jidx)
    e_ext = (E_up - ext) >= (H_up - fg)
    E = jnp.maximum(E_up - ext, H_up - fg)
    diag = H + s
    Hno = jnp.maximum(jnp.maximum(diag, E), 0.0)
    C = Hno + g
    Cm = _cummax_exclusive(C, jidx)
    F = Cm - openF - g
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


def _extract_score(word, qcol):
    """word: (N, BW) int32 packed 4xint8 scores; qcol: (N, 1) int32 read
    base.  Returns (N, BW) f32 substitution scores."""
    shift = jnp.minimum(qcol, 3) * 8
    v = (word >> shift) & 0xFF
    v = v - jnp.where(v >= 128, 256, 0)
    s = v.astype(jnp.float32) * (1.0 / SCALE)
    return jnp.where(qcol >= 4, jnp.float32(PAD_BYTE / SCALE), s)


@functools.partial(jax.jit, static_argnames=('fg', 'ext', 'openF'))
def _prof_jax(q, sp, g, qlens, *, fg, ext, openF):
    q = q.astype(jnp.int32)
    N, Lq = q.shape
    jidx = jnp.broadcast_to(jnp.arange(BW, dtype=jnp.float32)[None, :],
                            (N, BW))

    def step(carry, inp):
        H, E, bestH, bestI = carry
        qcol, i = inp
        wsp = jax.lax.dynamic_slice_in_dim(sp, i, BW, axis=1)
        wg = jax.lax.dynamic_slice_in_dim(g, i, BW, axis=1)
        s = _extract_score(wsp, qcol[:, None])
        H, E, code = _prof_tb_step(H, E, s, wg, jidx, fg, ext, openF)
        upd = (H > bestH) & ((i < qlens)[:, None])
        bestH = jnp.where(upd, H, bestH)
        bestI = jnp.where(upd, jnp.float32(i), bestI)
        return (H, E, bestH, bestI), code

    zeros = jnp.zeros((N, BW), jnp.float32)
    init = (zeros, jnp.full((N, BW), NEG), jnp.full((N, BW), NEG), zeros)
    (H, E, bestH, bestI), codes = jax.lax.scan(
        step, init, (q.T, jnp.arange(Lq)), unroll=4)
    codes = jnp.transpose(codes, (1, 0, 2)).reshape(N, Lq // 8, 8, BW)
    shifts = (jnp.arange(8, dtype=jnp.int32) * 4)[None, None, :, None]
    bits = jnp.sum(codes << shifts, axis=2)
    score = jnp.max(bestH, axis=1)
    is_best = bestH == score[:, None]
    big = jnp.float32(1e9)
    lane = jnp.min(jnp.where(is_best, jidx, big), axis=1)
    qend = jnp.min(jnp.where(is_best, bestI, big), axis=1)
    score = jnp.maximum(score, 0.0)
    none = score <= 0.0
    return (score, jnp.where(none, 0, qend).astype(jnp.int32),
            jnp.where(none, 0, lane).astype(jnp.int32), bits)


def profile_banded_tb(q, sp, g, qlens, scoring: ScoringConfig):
    """Banded read-vs-profile alignment emitting traceback bits.

    Args: q (N, Lq) uint8 read codes (4 = pad); sp (N, Lq+256) int32 packed
    per-column scores (byte b = score of read base b, x16 fixed point);
    g (N, Lq+256) float32 cumulative per-column deletion costs; qlens (N,).
    Returns (score, qend, lane, bits)."""
    kw = dict(fg=first_gap_cost(scoring), ext=float(scoring.gap_extend),
              openF=first_gap_cost(scoring) - float(scoring.gap_extend))
    q = jnp.asarray(q)
    sp = jnp.asarray(sp, jnp.int32)
    g = jnp.asarray(g, jnp.float32)
    qlens = jnp.asarray(qlens, jnp.int32)
    return _prof_jax(q, sp, g, qlens, **kw)


@functools.partial(jax.jit, static_argnames=('fg', 'ext', 'openF'))
def _prof_walk_impl(q, sp, g, qlens, *, fg, ext, openF):
    kw = dict(fg=fg, ext=ext, openF=openF)
    score, qend, lane, bits = _prof_jax(q, sp, g, qlens, **kw)
    packed, emits_packed = tb.walk_packed(score, qend, lane, bits)
    return packed, emits_packed, score


def profile_align_walk(q, sp, g, qlens, scoring: ScoringConfig):
    """Kernel + device traceback walk in one dispatch.  Returns host-side
    (score f32, qend, lane, qstart, l_fin, cigars)."""
    kw = dict(fg=first_gap_cost(scoring), ext=float(scoring.gap_extend),
              openF=first_gap_cost(scoring) - float(scoring.gap_extend))
    packed, emits, score = _prof_walk_impl(
        jnp.asarray(q), jnp.asarray(sp, jnp.int32),
        jnp.asarray(g, jnp.float32), jnp.asarray(qlens, jnp.int32), **kw)
    from fslr_tpu import instrument
    instrument.add_cells(int(np.asarray(qlens, np.int64).sum())
                         * int(np.shape(g)[-1]), 'profile')
    _, qend, lane, qstart, l_fin, cigars = tb.finalize_extend(packed, emits)
    return (np.asarray(score, np.float32), qend, lane, qstart, l_fin,
            cigars)
