"""Tandem-repeat masking: a tantan-equivalent HMM, batched in JAX.

The reference shells out to the ``tantan`` C++ binary to lowercase-mask
tandem repeats before junk filtering (/root/reference/fslr/filter_junk_from_fq.py:219-221).
This module implements the same probabilistic model class (Frith 2011,
"A new repeat-masking method enables specific detection of homologous
sequences") as a batched forward-backward scan over fixed-shape read arrays:

  states:       background b, repeat states r_d for periods d = 1..P
  transitions:  b->r_d proportional to decay^d summing to repeat_start;
                r_d->b = repeat_end; r_d->r_d = 1 - repeat_end
  emissions:    background uniform over ACGT; r_d emits base matching
                seq[i-d] with prob match_prob, else (1-match_prob)/3; any
                comparison involving N has likelihood ratio 1.

Positions with posterior P(repeat) >= posterior_threshold are masked.  The
scan state is (B, P+1) per position; the forward pass stores per-position
normalized state vectors in device memory (they are consumed by the
backward pass), so peak memory is O(B * L * P) — callers bucket batch
sizes accordingly.  This scan is the only implementation on every backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from fslr_tpu.config import JunkFilterConfig


@functools.partial(jax.jit, static_argnames=('P',))
def _mask_impl(seq, lens, P, start_total, end_p, decay, match_p, thresh):
    B, L = seq.shape
    seq = seq.astype(jnp.int32)

    d_idx = jnp.arange(1, P + 1, dtype=jnp.float32)
    start_d = decay ** d_idx
    start_d = start_d / jnp.sum(start_d) * start_total   # (P,)
    stay_b = 1.0 - start_total
    stay_r = 1.0 - end_p

    match_ratio = match_p / 0.25
    mismatch_ratio = (1.0 - match_p) / 3.0 / 0.25

    # window[b, d-1] = seq[b, i-d]; 5 = "no base yet" sentinel (ratio 0:
    # a repeat with period d cannot start before position d).
    init_win = jnp.full((B, P), 5, jnp.int32)

    def emission(win, x):
        xb = x[:, None]
        has_n = (xb == 4) | (win == 4)
        invalid = win == 5
        m = xb == win
        er = jnp.where(m, match_ratio, mismatch_ratio)
        er = jnp.where(has_n, 1.0, er)
        return jnp.where(invalid, 0.0, er)      # (B, P)

    def fwd_step(carry, x):
        fb, fr, win = carry
        er = emission(win, x)
        fr_new = (fr * stay_r + fb[:, None] * start_d[None, :]) * er
        fb_new = fb * stay_b + jnp.sum(fr, axis=1) * end_p
        z = fb_new + jnp.sum(fr_new, axis=1)
        z = jnp.maximum(z, 1e-30)
        fb_new = fb_new / z
        fr_new = fr_new / z[:, None]
        win = jnp.roll(win, 1, axis=1).at[:, 0].set(x)
        return (fb_new, fr_new, win), (fb_new, fr_new)

    xT = seq.T  # (L, B)
    (_, _, win_final), (fb_all, fr_all) = jax.lax.scan(
        fwd_step, (jnp.ones((B,)), jnp.zeros((B, P)), init_win), xT, unroll=8)

    # Backward pass: beta_i(s) = sum_s' T(s,s') e_{s'}(i+1) beta_{i+1}(s'),
    # with beta_{L-1} = 1.  Scanning k = 0..L-1 (p = L-1-k), each step first
    # EMITS the incoming carry (beta_p), then computes beta_{p-1} using the
    # emission at position p, which compares seq[p] with window(p) =
    # [seq[p-1] ... seq[p-P]].  window(p) is obtained from window(p+1) by
    # dropping seq[p] at the front and appending seq[p-P] at the back
    # (supplied as a precomputed shifted column; sentinel 5 when p < P).
    pad = jnp.full((B, P), 5, jnp.int32)
    seq_ext = jnp.concatenate([pad, seq], axis=1)   # seq_ext[:, r] = seq[:, r-P]
    back_cols = seq_ext[:, :L].T                    # back_cols[p] = seq[p-P]

    def bwd_step(carry, inp):
        bb, br, win = carry
        x_p, x_back = inp
        emit = (bb, br)
        win = jnp.roll(win, -1, axis=1).at[:, P - 1].set(x_back)  # window(p)
        er = emission(win, x_p)                      # e_{s'}(p)
        w = er * br                                  # (B, P)
        bb_new = stay_b * bb + jnp.sum(start_d[None, :] * w, axis=1)
        br_new = stay_r * w + end_p * bb[:, None]
        z = bb_new + jnp.sum(br_new, axis=1)
        z = jnp.maximum(z, 1e-30)
        return (bb_new / z, br_new / z[:, None], win), emit

    # win_final from the forward pass is window(L) = [seq[L-1] ... seq[L-P]]
    init_b = (jnp.ones((B,)), jnp.ones((B, P)), win_final)
    (_, _, _), (bb_all, br_all) = jax.lax.scan(
        bwd_step, init_b, (xT[::-1], back_cols[::-1]), unroll=8)
    bb_all = bb_all[::-1]
    br_all = br_all[::-1]

    num = jnp.sum(fr_all * br_all, axis=2)                  # (L, B)
    den = num + fb_all * bb_all
    posterior = num / jnp.maximum(den, 1e-30)
    mask = (posterior >= thresh).T                          # (B, L)
    pos = jnp.arange(L)[None, :]
    return mask & (pos < lens[:, None]) & (seq != 4)


def repeat_mask(seq, lens, cfg: JunkFilterConfig):
    """Boolean repeat mask (B, L) for encoded reads (uint8, 4 = N)."""
    return _mask_impl(
        jnp.asarray(seq), jnp.asarray(lens, jnp.int32), cfg.mask_max_period,
        cfg.mask_repeat_start, cfg.mask_repeat_end, cfg.mask_decay,
        cfg.mask_match_prob, cfg.mask_posterior_threshold)
