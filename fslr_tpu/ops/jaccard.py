"""Batched greedy Jaccard similarity over breakpoint-interval lists.

Replicates ``overall_jaccard_similarity``
(/root/reference/fslr/cluster.py:140-170) as a fixed-shape device kernel:
for each candidate read pair, intervals of list 1 are matched greedily (in
list order) to the FIRST unused interval of list 2 on the same chromosome
with reciprocal overlap >= ``percentage`` — reciprocal overlap divides the
reference-coordinate overlap by each interval's *query* aln_size, an
intentional quirk of the reference (cluster.py:133-136) that we preserve.

jaccard = intersection / (len1 + len2 - intersection).

Lists are padded to M slots; pairs whose lists exceed M are flagged so the
caller can fall back to an exact host computation (rare: lists are reads'
interior alignment counts).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=('M',))
def _jaccard_impl(c1, s1, e1, z1, v1, c2, s2, e2, z2, v2, len1, len2, pct,
                  M):
    N = c1.shape[0]
    used = jnp.zeros((N, M), jnp.bool_)
    inter = jnp.zeros(N, jnp.int32)

    def body(i, carry):
        used, inter = carry
        ci = c1[:, i][:, None]
        si = s1[:, i][:, None].astype(jnp.float32)
        ei = e1[:, i][:, None].astype(jnp.float32)
        zi = z1[:, i][:, None]
        vi = v1[:, i][:, None]
        ov = jnp.maximum(
            0.0, jnp.minimum(ei, e2.astype(jnp.float32))
            - jnp.maximum(si, s2.astype(jnp.float32)))
        rec = jnp.minimum(ov / jnp.maximum(zi, 1e-9),
                          ov / jnp.maximum(z2, 1e-9))
        match = (vi & v2 & ~used & (ci == c2) & (rec >= pct))
        any_m = jnp.any(match, axis=1)
        jm = jnp.argmax(match, axis=1)          # first True
        onehot = jnp.arange(M)[None, :] == jm[:, None]
        used = used | (onehot & any_m[:, None])
        inter = inter + any_m.astype(jnp.int32)
        return used, inter

    if M <= 8:
        # unrolled: the whole greedy chain compiles to ONE fusion, so the
        # gathered interval rows are read from HBM once — the fori_loop
        # form re-reads every (N, M) operand per iteration, which made
        # valuing 250M pairs memory-bound at scale
        carry = (used, inter)
        for i in range(M):
            carry = body(i, carry)
        used, inter = carry
    else:
        used, inter = jax.lax.fori_loop(0, M, body, (used, inter))
    union = len1 + len2 - inter
    j = jnp.where(union > 0, inter.astype(jnp.float32)
                  / jnp.maximum(union, 1).astype(jnp.float32), 0.0)
    return j, inter


def jaccard_pairs(lists1, lists2, percentage: float, M: int = 32):
    """lists1/lists2: python lists (len N) of per-read interval tuples
    (chrom, start, end, aln_size).  Returns (j, n_i) numpy arrays; pairs
    with lists longer than M are computed exactly on host."""
    import numpy as np
    N = len(lists1)
    if N == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    c1 = np.zeros((N, M), np.int32); s1 = np.zeros((N, M), np.int32)
    e1 = np.zeros((N, M), np.int32); z1 = np.zeros((N, M), np.float32)
    v1 = np.zeros((N, M), bool)
    c2 = np.zeros((N, M), np.int32); s2 = np.zeros((N, M), np.int32)
    e2 = np.zeros((N, M), np.int32); z2 = np.zeros((N, M), np.float32)
    v2 = np.zeros((N, M), bool)
    len1 = np.zeros(N, np.int32); len2 = np.zeros(N, np.int32)
    overflow = []
    for n, (l1, l2) in enumerate(zip(lists1, lists2)):
        len1[n] = len(l1); len2[n] = len(l2)
        if len(l1) > M or len(l2) > M:
            overflow.append(n)
            continue
        for i, (c, s, e, z) in enumerate(l1):
            c1[n, i], s1[n, i], e1[n, i], z1[n, i], v1[n, i] = c, s, e, z, 1
        for i, (c, s, e, z) in enumerate(l2):
            c2[n, i], s2[n, i], e2[n, i], z2[n, i], v2[n, i] = c, s, e, z, 1
    from fslr_tpu.ops.ssw import pad_rows_pow2
    NP = pad_rows_pow2(N, 8)
    if NP != N:
        pads = [(0, NP - N)]
        c1, s1, e1, z1, v1, c2, s2, e2, z2, v2, len1, len2 = (
            np.pad(x, pads + [(0, 0)] * (x.ndim - 1))
            for x in (c1, s1, e1, z1, v1, c2, s2, e2, z2, v2, len1, len2))
    j, inter = _jaccard_impl(*(jnp.asarray(x) for x in
                               (c1, s1, e1, z1, v1, c2, s2, e2, z2, v2,
                                len1, len2)), float(percentage), M)
    j = np.asarray(j)[:N].copy()
    inter = np.asarray(inter)[:N].copy()
    for n in overflow:
        j[n], inter[n] = jaccard_host(lists1[n], lists2[n], percentage)
    return j, inter


@functools.partial(jax.jit, static_argnames=('M',))
def _jaccard_gather(p, chrom, start, end, size, valid, lens, pct, M):
    """Gather both reads' interval rows for each pair and run the greedy
    matcher; returns ONE (2, N) float32 array (j row, n_i row) so a chunk
    costs a single device->host transfer."""
    a = p[:, 0]
    b = p[:, 1]
    iota = jnp.arange(M)[None, :]
    la = lens[a]
    lb = lens[b]
    # valid masks derive from lens — gathering the (N, M) valid table
    # costs an extra M bytes/row of HBM traffic for redundant data
    del valid
    j, n_i = _jaccard_impl(
        chrom[a], start[a], end[a], size[a], iota < la[:, None],
        chrom[b], start[b], end[b], size[b], iota < lb[:, None],
        la, lb, pct, M)
    return jnp.stack([j, n_i.astype(jnp.float32)])


def upload_interval_arrays(chrom, start, end, size, valid, lens):
    """Move the per-read padded interval arrays to device once; the tuple
    feeds every jaccard_pairs_indexed call (repeated calls with numpy
    inputs would re-upload per call).  The read dimension is padded to a
    power of two: the gathered-table shape is baked into the compiled
    kernel, and an unpadded R would recompile per dataset."""
    import numpy as np
    if isinstance(chrom, jax.Array):    # already a device tuple member
        return (chrom, start, end, size, valid, lens)
    R = len(lens)
    R2 = max(256, 1 << (max(R - 1, 1)).bit_length())
    if R2 != R:
        pad2 = [(0, R2 - R), (0, 0)]
        chrom, start, end, size, valid = (
            np.pad(x, pad2) for x in (chrom, start, end, size, valid))
        lens = np.pad(lens, (0, R2 - R))
    return (jnp.asarray(chrom), jnp.asarray(start), jnp.asarray(end),
            jnp.asarray(size, jnp.float32), jnp.asarray(valid),
            jnp.asarray(lens, jnp.int32))


def jaccard_pairs_indexed(pairs, chrom, start, end, size, valid, lens,
                          percentage: float, M: int = 32,
                          chunk: int = 1 << 18):
    """Scale path: pair similarities via device-side gathers.

    Args:
      pairs: (N, 2) int32 read indices (l1 role first — greedy matching is
        role-dependent).
      chrom/start/end/size/valid: (R, M) per-read padded interval arrays
        (numpy, or device arrays from :func:`upload_interval_arrays`).
      lens: (R,) true interval counts (may exceed M; such reads are
        handled exactly on host by the caller's fallback).
    Returns (j, n_i) numpy arrays of length N.
    """
    import numpy as np

    from fslr_tpu import instrument
    N = len(pairs)
    if N == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    # greedy-Jaccard valuing is an MxM interval-match DP per pair
    instrument.add_cells(N * M * M, 'jaccard')
    dev = upload_interval_arrays(chrom, start, end, size, valid, lens)

    js = np.zeros(N, np.float32)
    ns = np.zeros(N, np.int32)
    pairs = np.asarray(pairs, np.int32)
    pending = []
    # exactly two padded batch shapes -> at most two compiled kernels
    # (pow2 padding compiled a fresh kernel per magnitude)
    small = min(4096, chunk)
    for off in range(0, N, chunk):
        part = pairs[off:off + chunk]
        n0 = len(part)
        npad = small if n0 <= small else chunk
        if npad != n0:
            part = np.concatenate(
                [part, np.zeros((npad - n0, 2), np.int32)])
        pending.append((off, n0, _jaccard_gather(
            jnp.asarray(part), *dev, float(percentage), M=M)))
    for off, n0, packed in pending:
        p = np.asarray(packed)
        js[off:off + n0] = p[0, :n0]
        ns[off:off + n0] = p[1, :n0].astype(np.int32)
    return js, ns


def jaccard_host(l1, l2, percentage):
    """Exact host mirror (same greedy-first-match semantics)."""
    if not l1 or not l2:
        return 0.0, 0
    used = [False] * len(l2)
    inter = 0
    for (c, s, e, z) in l1:
        for jn, (c2_, s2_, e2_, z2_) in enumerate(l2):
            if used[jn]:
                continue
            ov = max(0, min(e, e2_) - max(s, s2_))
            if c == c2_ and z > 0 and z2_ > 0 \
                    and min(ov / z, ov / z2_) >= percentage:
                used[jn] = True
                inter += 1
                break
    union = len(l1) + len(l2) - inter
    if union == 0:
        return 0.0, 0
    return inter / union, inter
