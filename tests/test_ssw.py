"""Unit tests for the batched Smith-Waterman kernel vs the NumPy oracle."""

import numpy as np
import pytest

from fslr_tpu.config import ScoringConfig
from fslr_tpu.ops import ssw
from tests.oracles import sw_oracle, sw_locate_oracle, random_seq, mutate

SSW_SC = ScoringConfig()                                  # ssw convention
BWA_SC = ScoringConfig(gap_open_is_first_base=False)      # bwa convention


def _batchify(pairs, T):
    B = len(pairs)
    q = np.full((B, ssw.QP), 4, dtype=np.uint8)
    t = np.full((B, T), 4, dtype=np.uint8)
    qlens = np.zeros(B, dtype=np.int32)
    tlens = np.zeros(B, dtype=np.int32)
    for i, (qq, tt) in enumerate(pairs):
        q[i, :len(qq)] = qq
        t[i, :len(tt)] = tt
        qlens[i] = len(qq)
        tlens[i] = len(tt)
    return q, t, qlens, tlens


def _check(pairs, sc, backend, T=512):
    q, t, qlens, tlens = _batchify(pairs, T)
    score, tend, qend = ssw.sw_max(q, t, qlens, tlens, sc, backend=backend)
    score, tend, qend = map(np.asarray, (score, tend, qend))
    fg = ssw.first_gap_cost(sc)
    for i, (qq, tt) in enumerate(pairs):
        es, eti, eqj = sw_oracle(qq, tt, sc.match, sc.mismatch, fg,
                                 sc.gap_extend)
        assert score[i] == es, (i, score[i], es)
        assert tend[i] == eti, (i, tend[i], eti)
        assert qend[i] == eqj, (i, qend[i], eqj)


@pytest.mark.parametrize('backend', ['jax', pytest.param('cuda', marks=pytest.mark.gpu)])
@pytest.mark.parametrize('sc', [SSW_SC, BWA_SC], ids=['ssw', 'bwa'])
def test_sw_random(backend, sc):
    rng = np.random.default_rng(0)
    pairs = []
    for _ in range(24):
        qlen = rng.integers(5, 69)
        tlen = rng.integers(5, 400)
        pairs.append((random_seq(rng, qlen, 0.05), random_seq(rng, tlen, 0.05)))
    _check(pairs, sc, backend)


@pytest.mark.parametrize('backend', ['jax'])
def test_sw_planted_motif(backend):
    """A mutated copy of the query planted inside the target must be found."""
    rng = np.random.default_rng(1)
    pairs = []
    for _ in range(16):
        qq = random_seq(rng, 20)
        tt = random_seq(rng, 300)
        pos = rng.integers(0, 280)
        ins = mutate(rng, qq, sub=0.02, indel=0.0)
        tt = np.concatenate([tt[:pos], ins, tt[pos:]])[:400]
        pairs.append((qq, tt))
    q, t, qlens, tlens = _batchify(pairs, 512)
    score, tend, qend = ssw.sw_max(q, t, qlens, tlens, SSW_SC, backend=backend)
    # a 20-mer copy with at most one substitution scores >= 2*19 - 3 - 2*1
    assert np.all(np.asarray(score) >= 28)
    _check(pairs, SSW_SC, backend)


@pytest.mark.parametrize('backend', ['jax'])
def test_sw_no_alignment(backend):
    """poly-A query vs poly-T target: no positive score."""
    qq = np.zeros(20, dtype=np.uint8)
    tt = np.full(100, 3, dtype=np.uint8)
    q, t, qlens, tlens = _batchify([(qq, tt)], 128)
    score, tend, qend = ssw.sw_max(q, t, qlens, tlens, SSW_SC, backend=backend)
    assert float(score[0]) == 0.0


@pytest.mark.parametrize('backend', ['jax'])
def test_sw_locate(backend):
    rng = np.random.default_rng(2)
    pairs = []
    for _ in range(12):
        qq = random_seq(rng, rng.integers(10, 68))
        tt = random_seq(rng, rng.integers(50, 450))
        pos = rng.integers(0, max(1, len(tt) - len(qq)))
        tt = tt.copy()
        n = min(len(qq), len(tt) - pos)
        tt[pos:pos + n] = qq[:n]
        pairs.append((qq, tt))
    q, t, qlens, tlens = _batchify(pairs, 512)
    res = ssw.sw_locate(q, t, qlens, tlens, SSW_SC, backend=backend)
    for i, (qq, tt) in enumerate(pairs):
        exp = sw_locate_oracle(qq, tt)
        for k in ('score', 'target_begin', 'target_end', 'query_begin',
                  'query_end'):
            assert np.asarray(res[k])[i] == exp[k], (i, k, res[k][i], exp[k])


def test_exact_match_score():
    qq = np.array([0, 1, 2, 3] * 5, dtype=np.uint8)   # 20bp
    tt = np.concatenate([random_seq(np.random.default_rng(3), 50),
                         qq,
                         random_seq(np.random.default_rng(4), 50)])
    q, t, qlens, tlens = _batchify([(qq, tt)], 128)
    score, tend, qend = ssw.sw_max(q, t, qlens, tlens, SSW_SC, backend='jax')
    assert float(score[0]) == 40.0      # 20 matches * 2
    assert int(qend[0]) == 19


@pytest.mark.parametrize('backend', ['jax', pytest.param('cuda', marks=pytest.mark.gpu)])
def test_sw_max_packed_matches_per_query(backend):
    """Row max of the lane-packed kernel == max over per-primer sw_max
    rows (segment isolation: no cross-primer paths)."""
    rng = np.random.default_rng(21)
    primers = [random_seq(rng, int(rng.integers(18, 25))) for _ in range(4)]
    rows, _, _ = ssw.pack_queries(primers, 32)
    assert rows.shape == (1, 128)
    n = 6
    T = 512
    targets = np.full((n, T), 4, np.uint8)
    tlens = np.zeros(n, np.int32)
    for r in range(n):
        t = random_seq(rng, T - 10)
        if r % 2 == 0:     # embed a mutated primer
            p = mutate(rng, primers[r % len(primers)], sub=0.08, indel=0.04)
            pos = int(rng.integers(0, T - 10 - len(p)))
            t[pos:pos + len(p)] = p
        targets[r, :len(t)] = t
        tlens[r] = len(t)
    q = np.broadcast_to(rows[0], (n, 128)).copy()
    score_p, _, _ = ssw.sw_max_packed(q, targets, tlens, SSW_SC, 32,
                                      backend=backend)
    score_p = np.asarray(score_p)
    # reference: one sw_max row per primer
    best = np.zeros(n, np.float32)
    for p in primers:
        qp = np.full((n, 128), 4, np.uint8)
        qp[:, :len(p)] = p
        qlens = np.full(n, len(p), np.int32)
        s, _, _ = ssw.sw_max(qp, targets, qlens, tlens, SSW_SC,
                             backend=backend)
        best = np.maximum(best, np.asarray(s))
    assert np.allclose(score_p, best), (score_p, best)


def test_sw_max_packed_no_cross_segment_leak():
    """Two primers that would chain into a higher score if lanes leaked:
    target contains primerA immediately followed by primerB; the packed
    score must equal max(individual scores), not their sum."""
    rng = np.random.default_rng(5)
    pA = random_seq(rng, 20)
    pB = random_seq(rng, 20)
    rows, _, _ = ssw.pack_queries([pA, pB], 32)
    target = np.concatenate([random_seq(rng, 100), pA, pB,
                             random_seq(rng, 100)])
    t = np.full((1, 256), 4, np.uint8)
    t[0, :len(target)] = target
    tlens = np.array([len(target)], np.int32)
    s_packed, _, _ = ssw.sw_max_packed(rows[:1], t, tlens, SSW_SC, 32,
                                       backend='jax')
    assert float(np.asarray(s_packed)[0]) == 40.0  # 20 * match(2), not 80
