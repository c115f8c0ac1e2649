"""Aligner tests: banded kernel, seeding, selection DP, end-to-end stage."""

import numpy as np
import pytest

from fslr_tpu.config import AlignConfig, PipelineConfig, ScoringConfig
from fslr_tpu.encode import decode, encode, revcomp, revcomp_str
from fslr_tpu.index.reference import (Reference, build_seed_index,
                                      load_reference)
from fslr_tpu.ops import banded, selection
from fslr_tpu.stages import align as align_stage
from tests.oracles import mutate, random_seq, sw_oracle

BWA_SC = ScoringConfig(gap_open_is_first_base=False)
CONFIG = PipelineConfig()


def _mk_ref(rng, sizes):
    names = [f'chr{i+1}' for i in range(len(sizes))]
    parts = [random_seq(rng, s) for s in sizes]
    lengths = np.array([len(p) for p in parts], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    return Reference(names=names, lengths=lengths, offsets=offsets,
                     codes=np.concatenate(parts))


# --------------------------- banded kernel ---------------------------------

@pytest.mark.parametrize('backend', ['jax', pytest.param('cuda', marks=pytest.mark.gpu)])
def test_banded_matches_unbanded(backend):
    """When the alignment stays inside the band, banded == full SW."""
    rng = np.random.default_rng(0)
    Lq = 256
    N = 4
    q = np.full((N, Lq), 4, np.uint8)
    w = np.full((N, Lq + 256), 4, np.uint8)
    qlens = np.zeros(N, np.int32)
    for r in range(N):
        read = random_seq(rng, 200)
        seg = mutate(rng, read, sub=0.05, indel=0.02)
        win = np.concatenate([random_seq(rng, 64), seg,
                              random_seq(rng, Lq + 256 - 64 - len(seg))])
        q[r, :len(read)] = read
        qlens[r] = len(read)
        w[r] = win[:Lq + 256]
    score, qend, lane = banded.banded_sw(q, w, qlens, BWA_SC, backend=backend)
    for r in range(N):
        es, eti, eqj = sw_oracle(q[r, :qlens[r]], w[r, :qlens[r] + 128],
                                 fg=7, ext=2)
        # oracle aligns q against the band's reachable window; banded best
        # must match the full DP when drift < 64
        assert float(score[r]) == es, (r, float(score[r]), es)
        assert int(qend[r]) == eqj
        assert int(qend[r]) + int(lane[r]) == eti  # rend consistency


def test_banded_exact_segment():
    rng = np.random.default_rng(1)
    read = random_seq(rng, 300)
    w = np.concatenate([random_seq(rng, 64), read, random_seq(rng, 300)])
    q = read[None, :].copy()
    q = np.pad(q, ((0, 0), (0, 384 - 300)), constant_values=4)
    wv = np.pad(w[None, :384 + 256], ((0, 0), (0, 0)))
    score, qend, lane = banded.banded_sw(
        q, wv[:, :384 + 256], np.array([300], np.int32), BWA_SC,
        backend='jax')
    assert float(score[0]) == 600.0
    assert int(qend[0]) == 299
    assert int(qend[0]) + int(lane[0]) == 299 + 64  # rend = planted offset+299


# --------------------------- selection DP ----------------------------------

def _select_oracle(cands, ol_cost=2, max_overlap=50000, min_score=21):
    """Brute-force best chain by DP over all subsets orderings (small n)."""
    cands = [c for c in cands if c[2] >= min_score]
    n = len(cands)
    best_val, best_set = 0.0, []
    import itertools
    for r in range(1, n + 1):
        for sub in itertools.combinations(range(n), r):
            cs = sorted((cands[i] for i in sub), key=lambda c: c[1])
            ok = True
            val = 0.0
            for i, c in enumerate(cs):
                val += c[2] * (c[3] if len(c) > 3 else 1.0)
                if i > 0:
                    ov = max(0, cs[i - 1][1] - c[0])
                    if ov > max_overlap:
                        ok = False
                        break
                    val -= ol_cost * ov
            # chain order must be consistent: sorted by qend; overlaps only
            # between consecutive — approximate oracle for chain-like sets
            if ok and val > best_val:
                best_val = val
                best_set = sorted(sub)
    return best_val, best_set


def test_selection_simple_chain():
    # two disjoint segments + a low-scoring decoy overlapping both
    qs = np.array([[0, 800, 100]])
    qe = np.array([[800, 1400, 1300]])
    sc = np.array([[1500.0, 1100.0, 300.0]])
    v = np.ones((1, 3), bool)
    chosen = np.asarray(selection.select_alignments(qs, qe, sc, v))
    assert chosen[0].tolist() == [True, True, False]


def test_selection_overlap_cost():
    # overlapping pair: keep both only if combined beats single minus cost
    qs = np.array([[0, 500], [0, 900]])
    qe = np.array([[1000, 1500], [1000, 1100]])
    sc = np.array([[900.0, 800.0], [900.0, 150.0]])
    v = np.ones((2, 2), bool)
    chosen = np.asarray(selection.select_alignments(qs, qe, sc, v))
    # row 0: overlap 500 -> cost 1000; 900+800-1000=700 < 900 -> keep best
    assert chosen[0].tolist() == [True, False]
    # row 1: overlap 100 -> cost 200; 900+150-200=850 < 900? no: 850 < 900
    assert chosen[1].tolist() == [True, False]


def test_selection_min_score():
    qs = np.array([[0, 800]])
    qe = np.array([[800, 1400]])
    sc = np.array([[1500.0, 20.0]])        # second below dodi -u 21
    v = np.ones((1, 2), bool)
    chosen = np.asarray(selection.select_alignments(qs, qe, sc, v))
    assert chosen[0].tolist() == [True, False]


def test_selection_bias():
    # two mutually exclusive (full-overlap) candidates; bias flips winner
    qs = np.array([[0, 0]])
    qe = np.array([[1000, 1000]])
    sc = np.array([[1000.0, 980.0]])
    v = np.ones((1, 2), bool)
    bias = np.array([[1.0, 1.05]])
    chosen = np.asarray(selection.select_alignments(
        qs, qe, sc, v, bias=bias, max_overlap=50000))
    assert chosen[0].tolist() == [False, True]


# --------------------------- end-to-end stage ------------------------------

@pytest.fixture(scope='module')
def ref_and_index():
    rng = np.random.default_rng(42)
    ref = _mk_ref(rng, [20000, 20000])
    sidx = build_seed_index(ref, k=11)
    return ref, sidx


def test_align_exact_read(ref_and_index):
    ref, sidx = ref_and_index
    read = decode(ref.codes[3000:4000])
    out = align_stage.align_batch([read], ref, sidx, CONFIG, backend='jax')
    assert len(out) == 1
    assert ref.names[out.chrom_idx[0]] == 'chr1'
    assert abs(int(out.rstart[0]) - 3000) <= 2
    assert abs(int(out.rend[0]) - 3999) <= 2
    assert not out.strand_rev[0]
    assert out.is_primary[0]
    assert out.score[0] >= 1900


def test_align_reverse_strand(ref_and_index):
    ref, sidx = ref_and_index
    read = revcomp_str(decode(ref.codes[25000:26000]))  # chr2 local 5000
    out = align_stage.align_batch([read], ref, sidx, CONFIG, backend='jax')
    assert len(out) == 1
    assert ref.names[out.chrom_idx[0]] == 'chr2'
    assert out.strand_rev[0]
    assert abs(int(out.rstart[0]) - 5000) <= 2


def test_align_fusion_read(ref_and_index):
    ref, sidx = ref_and_index
    segA = decode(ref.codes[5000:5800])            # chr1
    segB = decode(ref.codes[20000 + 10000:20000 + 10600])  # chr2
    out = align_stage.align_batch([segA + segB], ref, sidx, CONFIG,
                                  backend='jax')
    assert len(out) == 2
    chroms = sorted(ref.names[c] for c in out.chrom_idx)
    assert chroms == ['chr1', 'chr2']
    spans = sorted((align_stage._fwd_span(out, i)) for i in range(2))
    assert abs(spans[0][0] - 0) <= 5 and abs(spans[0][1] - 800) <= 5
    assert abs(spans[1][0] - 800) <= 5 and abs(spans[1][1] - 1400) <= 5
    assert out.is_primary.sum() == 1


def test_align_mutated_read(ref_and_index):
    ref, sidx = ref_and_index
    rng = np.random.default_rng(9)
    seg = mutate(rng, ref.codes[8000:9500], sub=0.05, indel=0.02)
    out = align_stage.align_batch([decode(seg)], ref, sidx, CONFIG,
                                  backend='jax')
    assert len(out) >= 1
    pri = np.nonzero(out.is_primary)[0][0]
    assert ref.names[out.chrom_idx[pri]] == 'chr1'
    assert abs(int(out.rstart[pri]) - 8000) <= 20


def test_align_no_hit(ref_and_index):
    ref, sidx = ref_and_index
    rng = np.random.default_rng(10)
    out = align_stage.align_batch([decode(random_seq(rng, 500))], ref, sidx,
                                  CONFIG, backend='jax')
    # random 500bp vs 40kb random ref: no confident alignment expected
    for i in range(len(out)):
        assert out.score[i] < 100


def test_sharded_index_matches_unsharded():
    """Genomes above index.reference.MAX_UNSHARDED_BASES are split into
    contig-aligned int32 shards; alignments must be identical to the
    single-index path (forced here with a tiny shard cap)."""
    rng = np.random.default_rng(77)
    ref = _mk_ref(rng, [20000, 20000, 20000])
    sidx_full = build_seed_index(ref, k=11)
    sidx_sh = build_seed_index(ref, k=11, max_shard_bases=25000)
    assert sidx_sh.shards and len(sidx_sh.shards) >= 2
    # a split read: one segment on chr1, one reverse on chr3 (different
    # shards), plus an exact single-segment read
    segA = decode(ref.codes[2000:2800])
    segB = decode(revcomp(ref.codes[45000:45900]))
    reads = [segA + segB, decode(ref.codes[41000:42200])]
    a = align_stage.align_batch(reads, ref, sidx_full, CONFIG,
                                backend='jax')
    b = align_stage.align_batch(reads, ref, sidx_sh, CONFIG, backend='jax')
    rows_a = sorted(zip(a.read_idx.tolist(), a.chrom_idx.tolist(),
                        a.rstart.tolist(), a.rend.tolist(),
                        a.strand_rev.tolist(), a.score.tolist()))
    rows_b = sorted(zip(b.read_idx.tolist(), b.chrom_idx.tolist(),
                        b.rstart.tolist(), b.rend.tolist(),
                        b.strand_rev.tolist(), b.score.tolist()))
    assert rows_a == rows_b
    assert len(rows_a) >= 3
    names_hit = {ref.names[c] for _, c, *_ in rows_a}
    assert {'chr1', 'chr3'} <= names_hit


def test_shard_contig_ranges_packing():
    from fslr_tpu.index.reference import shard_contig_ranges
    assert shard_contig_ranges([10, 10, 10], 25) == [(0, 2), (2, 3)]
    assert shard_contig_ranges([30, 10], 25) == [(0, 1), (1, 2)]
    assert shard_contig_ranges([5], 25) == [(0, 1)]
    assert shard_contig_ranges([], 25) == [(0, 0)]


def test_window_lo_merge_matches_searchsorted():
    """The merge-rank window-start computation must equal the binary
    search it replaces (ops/seed.py)."""
    import jax.numpy as jnp

    from fslr_tpu.ops.seed import _window_lo_merge, _window_lo_search
    rng = np.random.default_rng(3)
    for trial in range(4):
        vals = np.sort(rng.integers(0, 2 ** 29, (5, 257)).astype(np.int32),
                       axis=1)
        # inject runs of duplicates (tie semantics matter for side='left')
        vals[:, 40:60] = vals[:, 40:41]
        vals = np.sort(vals, axis=1)
        a = np.asarray(_window_lo_merge(jnp.asarray(vals), 64))
        b = np.asarray(_window_lo_search(jnp.asarray(vals), 64))
        np.testing.assert_array_equal(a, b)


def test_bwa_style_mapq_model():
    """MAPQ model properties (bwa mem single-end family): unique strong
    hits max out, crowded/tied hits go to 0, sub-count penalizes."""
    from fslr_tpu.stages.align import _bwa_style_mapq

    # unique, perfect 500 bp alignment: s1 = 2*500, no competitor
    m_uniq = _bwa_style_mapq(1000, 0, 500, 500, 2, 3, 22, 0)
    assert m_uniq == 60
    # equal-scoring competitor -> 0
    assert _bwa_style_mapq(1000, 1000, 500, 500, 2, 3, 22, 1) == 0
    # competitor above -> still 0 (clamped)
    assert _bwa_style_mapq(1000, 1200, 500, 500, 2, 3, 22, 1) == 0
    # close competitor -> low but nonzero; monotone in the gap
    m_close = _bwa_style_mapq(1000, 980, 500, 500, 2, 3, 22, 1)
    m_mid = _bwa_style_mapq(1000, 950, 500, 500, 2, 3, 22, 1)
    assert 0 < m_close < m_mid <= 60
    # more sub-optimal hits -> lower mapq (gap small enough not to clamp)
    m_n1 = _bwa_style_mapq(1000, 950, 500, 500, 2, 3, 22, 1)
    m_n9 = _bwa_style_mapq(1000, 950, 500, 500, 2, 3, 22, 9)
    assert m_n9 < m_n1
    # low-identity alignment scores lower than a clean one of equal gap
    m_dirty = _bwa_style_mapq(400, 350, 500, 500, 2, 3, 22, 0)
    m_clean = _bwa_style_mapq(1000, 950, 500, 500, 2, 3, 22, 0)
    assert m_dirty < m_clean
    # degenerate inputs
    assert _bwa_style_mapq(0, 0, 100, 100, 2, 3, 22, 0) == 0
    assert _bwa_style_mapq(-5, 0, 100, 100, 2, 3, 22, 0) == 0


def test_zdrop_splits_near_diagonal_fusion(ref_and_index):
    """bwa z-drop equivalent (reference invocation -d 200,
    /root/reference/fslr/main.py:125): two segments whose diagonals sit
    within one band width (<128 apart) fuse into one seed candidate;
    the extension bridges the junction as a giant deletion, and the
    CIGAR-level splitter must report TWO alignments (as bwa would),
    each scored by its own bases."""
    ref, sidx = ref_and_index
    # read = ref[6000:6800] + ref[6920:7720]: a 120 bp deletion ->
    # diagonal separation 120 < BW=128, gap penalty 5 + 2*120 = 245 > 200
    read = decode(np.concatenate([ref.codes[6000:6800],
                                  ref.codes[6920:7720]]))
    out = align_stage.align_batch([read], ref, sidx, CONFIG, backend='jax')
    assert len(out) == 2, [
        (int(out.rstart[i]), int(out.rend[i]), int(out.score[i]))
        for i in range(len(out))]
    order = np.argsort(out.rstart)
    a, b = int(order[0]), int(order[1])
    assert abs(int(out.rstart[a]) - 6000) <= 2
    assert abs(int(out.rend[a]) - 6799) <= 2
    assert abs(int(out.rstart[b]) - 6920) <= 2
    assert abs(int(out.rend[b]) - 7719) <= 2
    # piece scores replay their own bases: ~2*800 each, no gap penalty
    assert int(out.score[a]) >= 1550 and int(out.score[b]) >= 1550
    assert int(out.is_primary.sum()) == 1
    # query coverage splits at the junction (forward strand)
    q_a = (int(out.qstart_o[a]), int(out.qend_o[a]))
    q_b = (int(out.qstart_o[b]), int(out.qend_o[b]))
    assert abs(q_a[0] - 0) <= 2 and abs(q_a[1] - 800) <= 2
    assert abs(q_b[0] - 800) <= 2 and abs(q_b[1] - 1600) <= 2
    # CIGARs stay consistent with the split coordinates
    cigs = out.cigar_lists()
    for i in (a, b):
        qspan = sum(n for n, op in cigs[i] if op in 'MI')
        rspan = sum(n for n, op in cigs[i] if op in 'MD')
        assert qspan == int(out.qend_o[i] - out.qstart_o[i])
        assert rspan == int(out.rend[i] - out.rstart[i] + 1)


def test_zdrop_keeps_small_deletion(ref_and_index):
    """A deletion below the z-drop threshold (5 + 2g <= 200, g <= 97)
    stays ONE alignment bridged by a D run, exactly as bwa would bridge
    it."""
    ref, sidx = ref_and_index
    read = decode(np.concatenate([ref.codes[9000:9700],
                                  ref.codes[9790:10400]]))   # 90 bp del
    out = align_stage.align_batch([read], ref, sidx, CONFIG, backend='jax')
    assert len(out) == 1
    assert abs(int(out.rstart[0]) - 9000) <= 2
    assert abs(int(out.rend[0]) - 10399) <= 2
    cig = out.cigar_lists()[0]
    assert any(op == 'D' and n >= 85 for n, op in cig)
