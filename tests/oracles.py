"""NumPy dynamic-programming oracles for kernel unit tests.

These are straightforward O(Q*T) implementations of the published recurrences
(affine-gap Smith-Waterman, Gotoh) used to validate the JAX and CUDA kernels.
End-position tie semantics mirror the ssw library as documented in
fslr_tpu/ops/ssw.py.
"""

import numpy as np

NEG = -1e30


def sw_oracle(q, t, match=2, mismatch=-3, fg=5, ext=2):
    """Full-matrix affine SW. q/t are uint8 code arrays (4 = N, mismatches all).

    Returns (score, target_end, query_end) with 0-based inclusive ends;
    (0, 0, 0) when no positive-scoring alignment exists.
    """
    Q, T = len(q), len(t)
    H = np.zeros((T + 1, Q + 1))
    E = np.full((T + 1, Q + 1), NEG)
    F = np.full((T + 1, Q + 1), NEG)
    bestH = np.full(Q + 1, NEG)   # per-column max over rows
    bestI = np.zeros(Q + 1, dtype=int)
    for i in range(1, T + 1):
        for j in range(1, Q + 1):
            E[i][j] = max(E[i - 1][j] - ext, H[i - 1][j] - fg)
            F[i][j] = max(F[i][j - 1] - ext, H[i][j - 1] - fg)
            s = match if (q[j - 1] == t[i - 1] and q[j - 1] < 4
                          and t[i - 1] < 4) else mismatch
            H[i][j] = max(0.0, H[i - 1][j - 1] + s, E[i][j], F[i][j])
            if H[i][j] > bestH[j]:
                bestH[j] = H[i][j]
                bestI[j] = i
    score = bestH[1:].max(initial=0.0)
    if score <= 0:
        return 0.0, 0, 0
    cols = [j for j in range(1, Q + 1) if bestH[j] == score]
    qend = min(cols) - 1
    tend = min(bestI[j] for j in cols) - 1
    return float(score), tend, qend


def sw_locate_oracle(q, t, match=2, mismatch=-3, fg=5, ext=2):
    score, tend, qend = sw_oracle(q, t, match, mismatch, fg, ext)
    if score <= 0:
        return dict(score=0.0, target_begin=0, target_end=0,
                    query_begin=0, query_end=0)
    rq = q[qend::-1]
    rt = t[tend::-1]
    _, rtend, rqend = sw_oracle(rq, rt, match, mismatch, fg, ext)
    return dict(score=score, target_begin=tend - rtend, target_end=tend,
                query_begin=qend - rqend, query_end=qend)


def random_seq(rng, n, n_frac=0.0):
    s = rng.integers(0, 4, size=n).astype(np.uint8)
    if n_frac:
        mask = rng.random(n) < n_frac
        s[mask] = 4
    return s


def mutate(rng, s, sub=0.05, indel=0.02):
    """Simple nanopore-ish mutator for synthetic read generation."""
    out = []
    for b in s:
        r = rng.random()
        if r < indel / 2:
            continue  # deletion
        if r < indel:
            out.append(rng.integers(0, 4))  # insertion
        if rng.random() < sub:
            out.append((b + rng.integers(1, 4)) % 4)
        else:
            out.append(b)
    return np.array(out, dtype=np.uint8)
