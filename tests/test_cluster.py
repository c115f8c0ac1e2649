"""Clustering stage tests (cluster.py + main.py block semantics)."""

import numpy as np
import pandas as pd
import pytest

from fslr_tpu.config import ClusterConfig
from fslr_tpu.ops import components, jaccard
from fslr_tpu.stages import cluster as C

CFG = ClusterConfig()
CHR_LEN = {'chr1': 10_000_000, 'chr2': 10_000_000}


def _read_rows(qname, segs, qlen, score=1000):
    """segs: list of (chrom, rstart, rend, qstart, qend)."""
    rows = []
    for (chrom, rs, re_, qs, qe) in segs:
        rows.append(dict(chrom=chrom, rstart=rs, rend=re_, qname=qname,
                         n_alignments=len(segs), aln_size=qe - qs,
                         qstart=qs, qend=qe, strand='+', mapq=60, qlen=qlen,
                         alignment_score=score, inferred_by_primer=0,
                         seq=''))
    return rows


def _bed(reads):
    rows = []
    for r in reads:
        rows += r
    return pd.DataFrame(rows)


def _df(table):
    """A stage's Table as a pandas frame (the tests' oracle library)."""
    return pd.DataFrame(table.to_dict(), index=table.index)


def _fusion_read(qname, interior_start, chrom='chr1', score=1000, jitter=0):
    """3-segment read: bread + one interior filling + bread."""
    s = interior_start + jitter
    return _read_rows(qname, [
        ('chr2', 8_000_000, 8_000_500, 0, 500),
        (chrom, s, s + 1000, 500, 1500),
        ('chr2', 8_100_000, 8_100_500, 1500, 2000),
    ], qlen=2000, score=score)


def test_cluster_two_groups_and_singletons():
    reads = []
    for i in range(4):
        reads.append(_fusion_read(f'A{i}.x.21q1F_17p6R', 2_000_000,
                                  score=1000 + i))
    for i in range(3):
        reads.append(_fusion_read(f'B{i}.x.21q1F_17p6R', 3_000_000,
                                  chrom='chr2', score=500 + i))
    reads.append(_fusion_read('C0.x.21q1F_17p6R', 5_000_000, score=10))
    bed = _bed(reads)
    res = C.cluster_stage(bed, CHR_LEN, CFG)
    assert not res.no_clusters
    cb = _df(res.cluster_bed)
    a_clusters = set(cb[cb['qname'].str.startswith('A')]['cluster'])
    b_clusters = set(cb[cb['qname'].str.startswith('B')]['cluster'])
    c_clusters = set(cb[cb['qname'].str.startswith('C')]['cluster'])
    assert len(a_clusters) == 1 and len(b_clusters) == 1
    assert a_clusters != b_clusters
    assert c_clusters.isdisjoint(a_clusters | b_clusters)
    # n_reads per group
    assert set(cb[cb['qname'].str.startswith('A')]['n_reads']) == {4}
    assert set(cb[cb['qname'].str.startswith('B')]['n_reads']) == {3}
    assert set(cb[cb['qname'].str.startswith('C')]['n_reads']) == {1}
    # chroms restored to strings
    assert set(cb['chrom']) <= {'chr1', 'chr2'}
    # representatives: best avg score per cluster -> A3, B2, C0
    rep_names = set(_df(res.representative_bed)['qname'].str.split('.').str[0])
    assert {'A3', 'B2', 'C0'} <= rep_names


def test_cluster_no_clusters():
    reads = [_fusion_read('A0.x.21q1F_17p6R', 2_000_000),
             _fusion_read('B0.x.21q1F_17p6R', 3_000_000, chrom='chr2')]
    res = C.cluster_stage(_bed(reads), CHR_LEN, CFG)
    assert res.no_clusters


def test_subtelomere_mask_drops_edge_intervals():
    # interior interval within 500kb of chromosome start -> masked out
    reads = [_fusion_read(f'A{i}.x.21q1F_17p6R', 100_000) for i in range(3)]
    res = C.cluster_stage(_bed(reads), CHR_LEN, CFG)
    assert res.no_clusters        # all interiors masked, no edges


def test_cluster_qlen_gate():
    # same breakpoint but very different interior spans -> gated by qlen2
    r1 = _read_rows('A0.x', [('chr2', 8_000_000, 8_000_500, 0, 500),
                             ('chr1', 2_000_000, 2_001_000, 500, 1500),
                             ('chr2', 8_100_000, 8_100_500, 1500, 2000)],
                    qlen=2000)
    r2 = _read_rows('A1.x', [('chr2', 8_000_000, 8_000_500, 0, 500),
                             ('chr1', 2_000_000, 2_001_000, 500, 3500),
                             ('chr2', 8_100_000, 8_100_500, 3500, 4000)],
                    qlen=4000)
    res = C.cluster_stage(_bed([r1, r2]), CHR_LEN, CFG)
    # qlen2 ratio 1000/3000 < 0.96 and n_alignments equal -> gate says
    # "not different" via n_alignments (3/3 >= 0.75) -> pair allowed;
    # jaccard: intervals overlap fully reciprocally? aln_size differs
    # (1000 vs 3000): overlap 1000 -> rec = min(1, 1/3) < 0.8 -> no edge
    assert res.no_clusters


def test_keep_fillings():
    bed = _bed([_read_rows('q1', [('chr1', 0, 100, 0, 100),
                                  ('chr1', 200, 300, 100, 200),
                                  ('chr1', 400, 500, 200, 300)], 300),
                _read_rows('q2', [('chr1', 0, 100, 0, 100),
                                  ('chr1', 400, 500, 100, 200)], 200)])
    out = C.keep_fillings(bed)
    assert list(out['qname']) == ['q1']
    assert list(out['qlen2']) == [100]


def test_rename_chromosomes_ordering():
    bed = pd.DataFrame({'chrom': ['chr10', 'chr2', 'chrX', 'chr1']})
    out, lens, mask, cmap = C.rename_chromosomes(bed, {}, [])
    assert cmap == {'chr1': 1, 'chr2': 2, 'chr10': 3, 'chrX': 4}


def test_jaccard_device_matches_host():
    rng = np.random.default_rng(3)
    lists1, lists2 = [], []
    for _ in range(40):
        def mk():
            n = rng.integers(1, 6)
            out = []
            for _ in range(n):
                c = int(rng.integers(1, 3))
                s = int(rng.integers(0, 5000))
                e = s + int(rng.integers(100, 2000))
                out.append((c, s, e, float(e - s)))
            return out
        lists1.append(mk())
        lists2.append(mk())
    j, n_i = jaccard.jaccard_pairs(lists1, lists2, 0.8)
    for i in range(40):
        je, ne = jaccard.jaccard_host(lists1[i], lists2[i], 0.8)
        assert abs(float(j[i]) - je) < 1e-6, i
        assert int(n_i[i]) == ne, i


def test_connected_components():
    edges = np.array([[0, 1], [1, 2], [3, 4], [5, 5]], np.int32)
    labels = np.asarray(components.connected_components(edges, 7))
    assert labels[0] == labels[1] == labels[2]
    assert labels[3] == labels[4]
    assert labels[0] != labels[3]
    assert labels[6] == 6


def _multi_filling_read(qname, s1, s2, jitter=0, n_fill=2, qlen=3000):
    """Read with n_fill interior fillings at breakpoints s1/s2(+jitter)."""
    segs = [('chr2', 8_000_000, 8_000_500, 0, 500)]
    q = 500
    starts = [s1, s2][:n_fill] + [s2 + 50_000 * k
                                  for k in range(n_fill - 2)]
    for s in starts:
        segs.append(('chr1', s + jitter, s + jitter + 1000, q, q + 1000))
        q += 1000
    segs.append(('chr2', 8_100_000, 8_100_500, q, q + 500))
    return _read_rows(qname, segs, qlen=q + 500)


def _mixed_dataset():
    """Recurrent groups (edge cap territory), jittered members, gate
    variation, multi-interval reads, and one read exceeding the Jaccard
    kernel's M cap (host-fallback path)."""
    reads = []
    # 15-read group at one breakpoint pair: cap (10) triggers mid-walk
    for i in range(15):
        reads.append(_multi_filling_read(f'G{i:02d}.x.21q1F_17p6R',
                                         2_000_000, 2_400_000,
                                         jitter=(i % 3) * 40))
    # 6-read single-filling group with jitter
    for i in range(6):
        reads.append(_fusion_read(f'H{i}.x.21q1F_17p6R', 3_000_000,
                                  jitter=(i % 2) * 100))
    # overlapping-but-different-qlen pair (gate boundary)
    reads.append(_read_rows('Q0.x', [('chr2', 8_000_000, 8_000_500, 0, 500),
                                     ('chr1', 5_000_000, 5_001_000, 500,
                                      1500),
                                     ('chr2', 8_100_000, 8_100_500, 1500,
                                      2000)], qlen=2000))
    reads.append(_read_rows('Q1.x', [('chr2', 8_000_000, 8_000_500, 0, 500),
                                     ('chr1', 5_000_000, 5_001_000, 500,
                                      1540),
                                     ('chr2', 8_100_000, 8_100_500, 1540,
                                      2040)], qlen=2040))
    # read with more intervals than the kernel cap M=32 (host fallback),
    # overlapping the G group's first breakpoint
    big = [('chr2', 8_000_000, 8_000_500, 0, 500)]
    q = 500
    for k in range(35):
        big.append(('chr1', 2_000_000 + 20 * k, 2_001_000 + 20 * k,
                    q, q + 1000))
        q += 1000
    big.append(('chr2', 8_100_000, 8_100_500, q, q + 500))
    reads.append(_read_rows('BIG0.x', big, qlen=q + 500))
    # singletons
    reads.append(_fusion_read('S0.x.21q1F_17p6R', 6_000_000))
    return _bed(reads)


def test_device_enumeration_matches_host():
    """The device encounter path (ops/encounters.py) must replay the exact
    traversal: identical edges (order included), node order, and match
    values (VERDICT round-1 item 2)."""
    import dataclasses as dc

    bed = _mixed_dataset()
    results = {}
    for tag, thresh in (('host', 1 << 62), ('device', 1)):
        # exact_cap_replay off: these tests check the device
        # ENUMERATION against the host's closed-form replay; capped
        # exact-walk semantics are covered by test_reference_oracle
        cfg = dc.replace(CFG, device_enum_min_encounters=thresh,
                         exact_cap_replay=False)
        b, lens, mask, cmap = C.rename_chromosomes(bed, CHR_LEN, set())
        fill = C.keep_fillings(b)
        data = C.prepare_data(fill, set(), lens)
        results[tag] = C.query_graph(
            data, cfg.overlap, list(cfg.jaccard_cutoffs),
            cfg.edge_threshold, cfg.qlen_diff, cfg.n_alignment_diff, cfg)

    m_host, e_host, n_host = results['host']
    m_dev, e_dev, n_dev = results['device']
    assert e_host == e_dev
    assert n_host == n_dev
    mh = _df(m_host).sort_values(['query1', 'query2']).reset_index(drop=True)
    md = _df(m_dev).sort_values(['query1', 'query2']).reset_index(drop=True)
    pd.testing.assert_frame_equal(mh, md)
    assert len(e_host) > 10          # edge cap actually exercised


def test_device_enumeration_random_soup_small_slices():
    """Random interval soup, tiny slice/merge caps: exercises multi-slice
    enumeration, the incremental device merge, and the borderline-gate
    host resolution; must equal the host path exactly."""
    import dataclasses as dc

    rng = np.random.default_rng(42)
    reads = []
    for g in range(10):
        base = 1_000_000 + g * 300_000
        for i in range(40):
            jitter = int(rng.integers(0, 120))
            reads.append(_fusion_read(f'R{g:02d}_{i:02d}.x', base,
                                      jitter=jitter))
    # borderline qlen2 ratio: 2400/2500 = 0.96 == 1 - qlen_diff exactly
    # (float64 ==, float32 within the band); n_aln ratio 3/5 < 0.75 fails
    # definitively, so the gate outcome hinges on the exact host check
    reads.append(_read_rows('BL0.x', [
        ('chr2', 8_000_000, 8_000_500, 0, 500),
        ('chr1', 5_000_000, 5_001_000, 500, 2900),
        ('chr2', 8_100_000, 8_100_500, 2900, 3400)], qlen=3400))
    reads.append(_read_rows('BL1.x', [
        ('chr2', 8_000_000, 8_000_300, 0, 300),
        ('chr1', 5_000_000, 5_000_800, 300, 1100),
        ('chr1', 5_000_700, 5_001_500, 1100, 1900),
        ('chr1', 5_001_400, 5_002_300, 1900, 2800),
        ('chr2', 8_100_000, 8_100_300, 2800, 3100)], qlen=3100))
    bed = _bed(reads)

    results = {}
    for tag, kw in (('host', dict(device_enum_min_encounters=1 << 62,
                                  exact_cap_replay=False)),
                    ('device', dict(device_enum_min_encounters=1,
                                    enum_slice_cap=4096,
                                    enum_merge_cap=8192))):
        cfg = dc.replace(CFG, **kw)
        b, lens, mask, cmap = C.rename_chromosomes(bed, CHR_LEN, set())
        data = C.prepare_data(C.keep_fillings(b), set(), lens)
        results[tag] = C.query_graph(
            data, cfg.overlap, list(cfg.jaccard_cutoffs),
            cfg.edge_threshold, cfg.qlen_diff, cfg.n_alignment_diff, cfg)
    assert results['host'][1] == results['device'][1]    # edges
    assert results['host'][2] == results['device'][2]    # node order
    assert len(results['host'][1]) > 50                  # nontrivial graph


def test_device_enumeration_cluster_stage():
    """End-to-end cluster_stage through the device path."""
    import dataclasses as dc

    bed = _mixed_dataset()
    cfg_dev = dc.replace(CFG, device_enum_min_encounters=1)
    res_dev = C.cluster_stage(bed, CHR_LEN, cfg_dev)
    res_host = C.cluster_stage(bed, CHR_LEN, CFG)
    assert not res_dev.no_clusters
    pd.testing.assert_frame_equal(_df(res_host.cluster_bed),
                                  _df(res_dev.cluster_bed))
    pd.testing.assert_frame_equal(_df(res_host.representative_bed),
                                  _df(res_dev.representative_bed))


def test_sliced_encounter_enumeration_matches(monkeypatch):
    """A tiny SLICE_CAP forces the bounded-memory encounter path through
    many slices; cluster membership and representatives must be identical
    to the single-slice result (the slice merge reduces to the same global
    per-pair first-encounter minima)."""
    rng = np.random.default_rng(7)
    reads = []
    for g in range(3):
        for i in range(30):
            reads.append(_fusion_read(
                f'G{g}R{i}.x.21q1F_17p6R', 2_000_000 + g * 500_000,
                score=100 + i, jitter=int(rng.integers(0, 40))))
    bed = _bed(reads)
    res_big = C.cluster_stage(bed, CHR_LEN, CFG)

    import fslr_tpu.stages.cluster as cm
    src = cm.query_graph.__globals__
    # shrink the cap by patching the module constant inside query_graph:
    # SLICE_CAP is a local literal, so patch via code path — rebuild the
    # stage with a tiny cap using the public seam below.
    monkeypatch.setattr(cm, 'ENCOUNTER_SLICE_CAP', 64, raising=True)
    res_small = C.cluster_stage(bed, CHR_LEN, CFG)

    def groups(res):
        return sorted((sorted(s) for s in
                       _df(res.cluster_bed).groupby('cluster')['qname']
                       .apply(set).tolist()))
    assert groups(res_big) == groups(res_small)
    pd.testing.assert_frame_equal(
        _df(res_big.cluster_bed).reset_index(drop=True),
        _df(res_small.cluster_bed).reset_index(drop=True))


@pytest.mark.parametrize('scale_path', ['sharded', 'spill'])
def test_scale_enumeration_matches_host(scale_path, monkeypatch):
    """The out-of-HBM scale paths — sharded (device pk/query-range
    buckets) and host-spill (fallback) — must replay the exact traversal
    like the host path."""
    import dataclasses as dc

    from fslr_tpu.ops import encounters as enc

    if scale_path == 'spill':
        # force the fallback: pretend the sharded build overflowed
        def _boom(*a, **k):
            raise enc._ShardOverflow('forced')
        monkeypatch.setattr(enc, '_build_entries_sharded', _boom)

    rng = np.random.default_rng(17)
    reads = []
    for g in range(8):
        base = 1_000_000 + g * 400_000
        for i in range(30):
            jitter = int(rng.integers(0, 100))
            reads.append(_fusion_read(f'Q{g:02d}_{i:02d}.x', base,
                                      jitter=jitter))
    bed = _bed(reads)

    results = {}
    for tag, kw in (('host', dict(device_enum_min_encounters=1 << 62,
                                  exact_cap_replay=False)),
                    ('scale', dict(device_enum_min_encounters=1,
                                   enum_spill_min_encounters=1,
                                   enum_slice_cap=4096)),
                    ('device', dict(device_enum_min_encounters=1,
                                    enum_slice_cap=4096))):
        cfg = dc.replace(CFG, **kw)
        b, lens, mask, cmap = C.rename_chromosomes(bed, CHR_LEN, set())
        data = C.prepare_data(C.keep_fillings(b), set(), lens)
        results[tag] = C.query_graph(
            data, cfg.overlap, list(cfg.jaccard_cutoffs),
            cfg.edge_threshold, cfg.qlen_diff, cfg.n_alignment_diff, cfg)
    for tag in ('scale', 'device'):
        assert results['host'][1] == results[tag][1], tag    # edges
        assert results['host'][2] == results[tag][2], tag    # node order
        mh = _df(results['host'][0]).sort_values(
            ['query1', 'query2']).reset_index(drop=True)
        mt = _df(results[tag][0]).sort_values(
            ['query1', 'query2']).reset_index(drop=True)
        pd.testing.assert_frame_equal(mh, mt)
    assert len(results['host'][1]) > 20


def test_capwalk_replay_matches_sequential_walk():
    """The closed-form emission formula (ops/capwalk.py) must equal a
    literal simulation of the reference's edge-capped walk
    (/root/reference/fslr/cluster.py:204-224: emit on pass, and once
    edge_count >= threshold skip the rest of the current interval's
    neighbors on every valued entry) for adversarial random patterns."""
    from fslr_tpu.ops import capwalk

    def sequential(passv, gated, runs, bounds, T):
        E = len(passv)
        emit = np.zeros(E, bool)
        R = len(bounds) - 1
        for q in range(R):
            lo, hi = bounds[q], bounds[q + 1]
            ec = 0
            i = lo
            while i < hi:
                if gated[i]:
                    if passv[i]:
                        ec += 1
                        emit[i] = True
                    if ec >= T:
                        cur = runs[i]
                        i += 1
                        while i < hi and runs[i] == cur:
                            i += 1
                        continue
                i += 1
        return emit

    rng = np.random.default_rng(123)
    for trial in range(200):
        R = int(rng.integers(1, 8))
        counts = rng.integers(0, 40, R)
        bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        E = int(bounds[-1])
        if E == 0:
            continue
        # runs: random run lengths within each query
        runs = np.zeros(E, np.int64)
        rc = np.zeros(E, bool)
        rid = 0
        for q in range(R):
            i = bounds[q]
            while i < bounds[q + 1]:
                ln = int(rng.integers(1, 6))
                j = min(i + ln, bounds[q + 1])
                runs[i:j] = rid
                rc[i] = True
                rid += 1
                i = j
        gated = rng.random(E) < rng.uniform(0.1, 0.9)
        passv = gated & (rng.random(E) < rng.uniform(0.1, 0.9))
        T = int(rng.integers(0, 6))
        eq = np.repeat(np.arange(R), counts)
        got = capwalk.replay(passv, gated, rc, eq, bounds, T)
        want = sequential(passv, gated, runs, bounds, T)
        np.testing.assert_array_equal(got, want, err_msg=f'trial {trial}')


def test_value_and_replay_host_chunked_matches_flat():
    """Query-aligned chunking of the host value+replay (config-5 RAM
    bound) must be exact: force 1-entry chunks on a capped frame and
    compare against the one-chunk pass."""
    import numpy as np

    from fslr_tpu.config import ClusterConfig
    from fslr_tpu.ops import capwalk as cw
    from fslr_tpu.stages import cluster as C
    from tests.test_reference_oracle import make_frame

    rng = np.random.default_rng(909)
    bed = make_frame(rng, n_groups=3, max_members=14, n_noise=5)
    # run the device-enumeration spill path twice with different chunk
    # sizes by monkeypatching the chunk default
    import functools
    orig = cw.value_and_replay_host
    outs = {}
    for label, ch in (('flat', 1 << 60), ('tiny', 7)):
        cw.value_and_replay_host = functools.partial(orig, chunk=ch)
        try:
            cfg = ClusterConfig(device_enum_min_encounters=0,
                                enum_spill_min_encounters=1,
                                edge_threshold=3)
            res = C.cluster_stage(
                bed.copy().assign(chrom=['chr%d' % c
                                         for c in bed['chrom']]),
                {f'chr{c}': 10_000_000 for c in
                 sorted(set(bed['chrom']))}, cfg)
            outs[label] = (None if res.no_clusters else
                           _df(res.cluster_bed).to_csv())
        finally:
            cw.value_and_replay_host = orig
    assert outs['flat'] == outs['tiny']


def test_spill_query_ranges_ragged_tail():
    """Phase 3 of the spill build buckets by query range with q_span =
    ceil(R / 64); when R is not a multiple of q_span the LAST range is
    shorter — the bincount accumulation must clip (found by the first
    full 10M config-5 run, which died here after its 62-minute build).
    69 reads -> q_span = 2, last range holds one read."""
    import numpy as np

    from fslr_tpu.config import ClusterConfig
    from fslr_tpu.stages import cluster as C

    rng = np.random.default_rng(6969)
    R = 69
    start = 100_000 + rng.integers(-40, 41, R)
    end = start + 1_000 + rng.integers(-40, 41, R)
    data = [C.IntervalItem(1, int(s), int(e), float(e - s), r, 3,
                           1_000, int((e - s) // 2 + s), r)
            for r, (s, e) in enumerate(zip(start, end))]
    data.sort(key=lambda it: it.start)
    cfg_spill = ClusterConfig(device_enum_min_encounters=0,
                              enum_spill_min_encounters=1,
                              exact_cap_replay=False)
    cfg_host = ClusterConfig(device_enum_min_encounters=1 << 62,
                             exact_cap_replay=False)
    out = {}
    for label, cfg in (('spill', cfg_spill), ('host', cfg_host)):
        m, edges, node_pos = C.query_graph(
            data, cfg.overlap, list(cfg.jaccard_cutoffs),
            cfg.edge_threshold, cfg.qlen_diff, cfg.n_alignment_diff, cfg)
        out[label] = (sorted(map(tuple, edges)), node_pos)
    assert out['spill'] == out['host']
