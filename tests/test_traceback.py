"""Traceback kernel tests: path consistency + score reconstruction."""

import numpy as np
import pytest

from fslr_tpu.config import ScoringConfig
from fslr_tpu.ops import traceback as tb
from tests.oracles import mutate, random_seq

BWA_SC = ScoringConfig(gap_open_is_first_base=False)


def _score_from_path(cigar, q, w, qstart, rstart_w, sc):
    fg = sc.gap_open + sc.gap_extend
    qi, ri = qstart, rstart_w
    score = 0
    for (n, op) in cigar:
        if op == 'M':
            for _ in range(n):
                score += sc.match if (q[qi] == w[ri] and q[qi] < 4
                                      and w[ri] < 4) else sc.mismatch
                qi += 1
                ri += 1
        elif op == 'I':
            score -= fg + (n - 1) * sc.gap_extend
            qi += n
        elif op == 'D':
            score -= fg + (n - 1) * sc.gap_extend
            ri += n
    return score, qi, ri


def test_traceback_paths():
    rng = np.random.default_rng(0)
    Lq = 256
    N = 6
    q = np.full((N, Lq), 4, np.uint8)
    w = np.full((N, Lq + 256), 4, np.uint8)
    qlens = np.zeros(N, np.int32)
    for r in range(N):
        read = random_seq(rng, 200)
        if r == 0:
            seg = read.copy()                       # exact
        else:
            seg = mutate(rng, read, sub=0.06, indel=0.03)
        win = np.concatenate([random_seq(rng, 64), seg,
                              random_seq(rng, Lq + 256)])[:Lq + 256]
        q[r, :len(read)] = read
        qlens[r] = len(read)
        w[r] = win
    score, qend, lane, bits = tb.banded_sw_tb(q, w, qlens, BWA_SC)
    score = np.asarray(score)
    qend = np.asarray(qend)
    lane = np.asarray(lane)
    bits = np.asarray(bits)
    ops, n_ops, i_fin, l_fin = tb.walk_paths(bits, qend, lane)
    for r in range(N):
        cigar = tb.ops_to_cigar(ops[r], int(n_ops[r]))
        qstart = int(i_fin[r]) + 1
        rstart_w = qstart + int(l_fin[r])
        ps, qi, ri = _score_from_path(cigar, q[r], w[r], qstart, rstart_w,
                                      BWA_SC)
        assert qi == int(qend[r]) + 1, (r, cigar[:5])
        assert ri == int(qend[r]) + int(lane[r]) + 1, r
        assert ps == int(score[r]), (r, ps, score[r], cigar[:8])
        if r == 0:
            assert cigar == [(200, 'M')]
            assert qstart == 0
            assert rstart_w == 64


def test_walk_empty_alignment():
    bits = np.zeros((1, 16, tb.BW), np.int32)
    ops, n_ops, i_fin, l_fin = tb.walk_paths(bits, np.array([0]),
                                             np.array([0]))
    assert n_ops[0] == 0


def test_device_walk_matches_host_walk():
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    Lq = 256
    N = 5
    q = np.full((N, Lq), 4, np.uint8)
    w = np.full((N, Lq + 256), 4, np.uint8)
    qlens = np.zeros(N, np.int32)
    for r in range(N):
        read = random_seq(rng, 220)
        seg = mutate(rng, read, sub=0.06, indel=0.04)
        win = np.concatenate([random_seq(rng, 70), seg,
                              random_seq(rng, Lq + 256)])[:Lq + 256]
        q[r, :len(read)] = read
        qlens[r] = len(read)
        w[r] = win
    score, qend, lane, bits = tb.banded_sw_tb(q, w, qlens, BWA_SC)
    # host path
    ops, n_ops, i_fin, l_fin = tb.walk_paths(np.asarray(bits),
                                             np.asarray(qend),
                                             np.asarray(lane))
    host_cigars = [tb.ops_to_cigar(ops[r], int(n_ops[r])) for r in range(N)]
    # device path
    T = bits.shape[1] * 8 + tb.BW
    emits, n2, i2, l2 = tb._walk_device(jnp.asarray(bits),
                                        jnp.asarray(qend),
                                        jnp.asarray(lane), T)
    dev_cigars, qstart2, lf2 = tb.cigars_from_emits(np.asarray(emits),
                                                    np.asarray(i2),
                                                    np.asarray(l2))
    for r in range(N):
        assert dev_cigars[r] == host_cigars[r], r
        assert int(qstart2[r]) == int(i_fin[r]) + 1
        assert int(lf2[r]) == int(l_fin[r])


def test_decode_emit_rows_native_matches_numpy():
    """Native C++ RLE (fslr_decode_emits) vs the numpy decode path on
    random packed blocks, including all-padding rows."""
    import numpy as np
    from fslr_tpu.io.native import decode_emits
    from fslr_tpu.ops import traceback as tbmod
    rng = np.random.default_rng(11)
    n, t4 = 64, 96
    blocks = rng.integers(0, 256, (n, t4)).astype(np.uint8)
    blocks[5] = 0xff                      # all "none"
    blocks[6, :t4 // 2] = 0xff            # half padding
    dec = decode_emits(blocks)
    if dec is None:
        import pytest
        pytest.skip('native library unavailable')
    got = tbmod.decode_emit_rows(blocks)
    want = [tbmod.decode_emit_row(blocks[r]) for r in range(n)]
    assert got == want


@pytest.mark.gpu
def test_banded_extend_cuda_matches_plain():
    """CUDA emit + walk vs the plain path: identical ends, begins and
    2-bit op streams (integer DP, so equality is exact)."""
    rng = np.random.default_rng(11)
    Lq, N = 256, 37
    q = np.full((N, Lq), 4, np.uint8)
    w = rng.integers(0, 4, (N, Lq + 256)).astype(np.uint8)
    qlens = np.zeros(N, np.int32)
    for r in range(N):
        read = random_seq(rng, int(rng.integers(40, Lq)))
        seg = mutate(rng, read, sub=0.06, indel=0.03)[:Lq + 192]
        q[r, :len(read)] = read
        qlens[r] = len(read)
        w[r, 64:64 + len(seg)] = seg
    kw = dict(match=2.0, mismatch=-3.0, fg=7.0, ext=2.0)
    gp, ge = tb.extend_windows(q, w, qlens, route='cuda', **kw)
    wp, we = tb.extend_windows(q, w, qlens, route='plain', **kw)
    np.testing.assert_array_equal(np.asarray(gp), np.asarray(wp))
    np.testing.assert_array_equal(np.asarray(ge), np.asarray(we))
