"""Mapping-table stage tests (collect_mapping_info semantics)."""

import numpy as np
import pandas as pd

from fslr_tpu.stages.align import Alignments
from fslr_tpu.stages import mapping_table as mt


def mapping_table(*args, **kwargs):
    """The stage's Table as a pandas frame (the tests' oracle library)."""
    return pd.DataFrame(mt.mapping_table(*args, **kwargs).to_dict())

PRIMERS = {'21q1': 'CTACCTCTCTCGACACCAAG', '17p6': 'GGCTGAACTATAGCCTCTGC'}


def _mk_aln(rows):
    keys = ['read_idx', 'chrom_idx', 'rstart', 'rend', 'strand_rev',
            'qstart_o', 'qend_o', 'qlen', 'score', 'mapq', 'is_primary',
            'overlaps_region']
    cols = {k: [] for k in keys}
    for r in rows:
        for k in keys:
            cols[k].append(r[k])
    types = dict(strand_rev=bool, is_primary=bool, overlaps_region=bool)
    return Alignments(**{k: np.array(v, types.get(k, np.int32))
                         for k, v in cols.items()})


def test_fusion_read_strand_flip():
    # read0: primary fwd chr1 q[0,800), secondary REV chr2, record coords
    # q_o[100,700) of a 1400bp read -> flipped onto primary strand:
    # start = 1400-700=700, end = 700 + 600 = 1300
    aln = _mk_aln([
        dict(read_idx=0, chrom_idx=0, rstart=999, rend=1798,
             strand_rev=False, qstart_o=0, qend_o=800, qlen=1400,
             score=1600, mapq=60, is_primary=True, overlaps_region=False),
        dict(read_idx=0, chrom_idx=1, rstart=4999, rend=5598,
             strand_rev=True, qstart_o=100, qend_o=700, qlen=1400,
             score=1200, mapq=60, is_primary=False, overlaps_region=False),
    ])
    df = mapping_table(aln, ['r0.1.0_1.0.21q1F_17p6R'], ['A' * 1400],
                       ['chr1', 'chr2'], None, PRIMERS)
    assert list(df['chrom']) == ['chr1', 'chr2']
    assert list(df['rstart']) == [1000, 5000]          # 1-based
    assert list(df['rend']) == [1799, 5599]
    assert list(df['strand']) == ['+', '-']
    assert list(df['qstart']) == [0, 700]
    assert list(df['qend']) == [800, 1300]
    assert list(df['n_alignments']) == [2, 2]
    # primary row carries the read sequence
    assert df.iloc[0]['seq'] == 'A' * 1400
    assert df.iloc[1]['seq'] == ''
    assert list(df['short_anchor<50bp']) == [0, 0]


def test_inferred_primer_pseudo_alignment():
    # single alignment, gap <= 5 at start, labelled 21q1F at p1
    aln = _mk_aln([
        dict(read_idx=0, chrom_idx=0, rstart=100, rend=999,
             strand_rev=False, qstart_o=3, qend_o=900, qlen=950,
             score=1700, mapq=60, is_primary=True, overlaps_region=False)])
    df = mapping_table(aln, ['r0.1.0_0.2.21q1F_False'], ['A' * 950],
                       ['chr1'], None, PRIMERS)
    assert len(df) == 2
    pseudo = df[df['inferred_by_primer'] == 1].iloc[0]
    assert pseudo['chrom'] == '21q1'
    assert pseudo['qstart'] == 0
    assert pseudo['qend'] == len(PRIMERS['21q1'])
    assert pseudo['strand'] == '+'
    assert (df['n_alignments'] == 2).all()


def test_inferred_primer_at_end():
    aln = _mk_aln([
        dict(read_idx=0, chrom_idx=0, rstart=100, rend=999,
             strand_rev=False, qstart_o=50, qend_o=948, qlen=950,
             score=1700, mapq=60, is_primary=True, overlaps_region=False)])
    df = mapping_table(aln, ['r0.0.3_1.0.False_17p6R'], ['A' * 950],
                       ['chr1'], None, PRIMERS)
    assert len(df) == 2
    pseudo = df[df['inferred_by_primer'] == 1].iloc[0]
    assert pseudo['chrom'] == '17p6'
    assert pseudo['strand'] == '-'
    assert pseudo['qstart'] == 950 - len(PRIMERS['17p6'])
    # short anchor: first alignment qstart=50 -> spans 898 >= 50, but the
    # pseudo alignment has aln_size 0 < 50 -> flagged
    assert (df['short_anchor<50bp'] == 1).all()


def test_gaps_both_ends_skip_pseudo():
    aln = _mk_aln([
        dict(read_idx=0, chrom_idx=0, rstart=100, rend=999,
             strand_rev=False, qstart_o=50, qend_o=900, qlen=950,
             score=1700, mapq=60, is_primary=True, overlaps_region=False)])
    df = mapping_table(aln, ['r0.1.0_1.0.21q1F_17p6R'], ['A' * 950],
                       ['chr1'], None, PRIMERS)
    assert len(df) == 1
    assert df.iloc[0]['n_alignments'] == 1


def test_sort_order_and_columns():
    aln = _mk_aln([
        dict(read_idx=0, chrom_idx=0, rstart=0, rend=99, strand_rev=False,
             qstart_o=30, qend_o=100, qlen=200, score=100, mapq=60,
             is_primary=True, overlaps_region=False),
        dict(read_idx=1, chrom_idx=0, rstart=0, rend=99, strand_rev=False,
             qstart_o=0, qend_o=100, qlen=300, score=100, mapq=60,
             is_primary=True, overlaps_region=False),
        dict(read_idx=1, chrom_idx=0, rstart=200, rend=299,
             strand_rev=False, qstart_o=100, qend_o=200, qlen=300,
             score=90, mapq=60, is_primary=False, overlaps_region=False),
        dict(read_idx=1, chrom_idx=0, rstart=400, rend=499,
             strand_rev=False, qstart_o=200, qend_o=300, qlen=300,
             score=80, mapq=60, is_primary=False, overlaps_region=False),
    ])
    df = mapping_table(aln, ['b.1.0_1.0.False_False', 'a.1.0_1.0.21q1F_17p6R'],
                       ['A' * 200, 'C' * 300], ['chr1'], None, PRIMERS)
    # n_alignments desc first: read 'a' (3 rows) before read 'b'
    assert list(df['qname'])[:3] == ['a.1.0_1.0.21q1F_17p6R'] * 3
    assert list(df['qstart'])[:3] == [0, 100, 200]
    assert list(df.columns) == [
        'chrom', 'rstart', 'rend', 'qname', 'n_alignments', 'aln_size',
        'qstart', 'qend', 'strand', 'mapq', 'qlen', 'alignment_score',
        'short_anchor<50bp', 'fslr_version', 'inferred_by_primer', 'seq']


def test_overlaps_region(tmp_path):
    bed = tmp_path / 'regions.bed'
    bed.write_text('chr1\t500\t2000\n')
    aln = _mk_aln([
        dict(read_idx=0, chrom_idx=0, rstart=999, rend=1500,
             strand_rev=False, qstart_o=0, qend_o=500, qlen=1000,
             score=900, mapq=60, is_primary=True, overlaps_region=False),
        dict(read_idx=0, chrom_idx=1, rstart=999, rend=1500,
             strand_rev=False, qstart_o=500, qend_o=1000, qlen=1000,
             score=900, mapq=60, is_primary=False, overlaps_region=False)])
    df = mapping_table(aln, ['r.1.0_1.0.21q1F_17p6R'], ['A' * 1000],
                       ['chr1', 'chr2'], str(bed), PRIMERS)
    assert 'overlaps_region' in df.columns
    assert sorted(df['overlaps_region']) == [0, 1]
