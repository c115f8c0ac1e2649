"""Differential oracle: the reference's collect_mapping_info row builder,
vendored, vs the repo's mapping_table_from_bam on randomized BAMs.

Round-3 verdict item 4 (second half): the reference's mapping-table
logic (/root/reference/fslr/collect_mapping_info.py:7-181) is vendored
VERBATIM below, with pysam's AlignmentFile/AlignedSegment replaced by a
thin shim over the repo's own BAM reader (io/bam.py) — the only
substitution; every coordinate, flag, primary-pick, strand-flip,
inferred-primer and sort rule is the reference's own code.  Both sides
read the SAME randomly generated BAM file, so the repo's BAM encoder
round-trips through the oracle as well.
"""

import collections

import numpy as np
import pandas as pd
import pytest

from fslr_tpu.encode import revcomp_str
from fslr_tpu.io import bam as bamio
from fslr_tpu.stages.mapping_table import mapping_table_from_bam

_CIG_CODE = {'M': 0, 'I': 1, 'D': 2, 'N': 3, 'S': 4, 'H': 5,
             'P': 6, '=': 7, 'X': 8}


class ShimRecord:
    """pysam.AlignedSegment surface used by collect_mapping_info, backed
    by io/bam.BamRecord (the substitution documented above)."""

    def __init__(self, rec):
        self._r = rec

    @property
    def flag(self):
        return self._r.flag

    @property
    def qname(self):
        return self._r.qname

    @property
    def rname(self):
        return self._r.ref_id

    @property
    def mapq(self):
        return self._r.mapq

    @property
    def reference_start(self):
        return self._r.pos

    @property
    def reference_end(self):
        return self._r.pos + self._r.reference_span()

    @property
    def cigartuples(self):
        return [(_CIG_CODE[op], n) for n, op in self._r.cigar]

    @property
    def seq(self):
        return self._r.seq or None

    def get_tag(self, tag):
        return self._r.tags[tag]

    def infer_read_length(self):
        return self._r.infer_read_length()

    def infer_query_length(self):
        return sum(n for n, op in self._r.cigar if op in 'MIS=X')

    def get_forward_sequence(self):
        if not self._r.seq:
            return None
        return revcomp_str(self._r.seq) if self._r.is_reverse else self._r.seq


# ---------------------------------------------------------------------------
# vendored reference logic (collect_mapping_info.py:7-181); pysam file ->
# (records, names), version string parameterized, to_csv -> DataFrame
# ---------------------------------------------------------------------------

def ref_get_query_pos_from_cigartuples(r):          # :7-16
    start = 0
    query_length = r.infer_read_length()
    end = query_length
    if r.cigartuples[0][0] == 4 or r.cigartuples[0][0] == 5:
        start += r.cigartuples[0][1]
    if r.cigartuples[-1][0] == 4 or r.cigartuples[-1][0] == 5:
        end -= r.cigartuples[-1][1]
    return start, end, query_length


def ref_mapping_info(records, names, regions_list, primers,
                     flsr_version):                 # :19-181
    d = collections.defaultdict(list)
    for a in records:
        if not a.flag & 4:
            d[a.qname].append(a)

    regions = collections.defaultdict(list)
    for (chrom, start, end) in regions_list:
        regions[chrom].append(pd.Interval(left=start, right=end))

    res = []
    no = 0
    yes = 0
    for qname, v in d.items():
        flag = [(index, i) for index, i in enumerate(v)
                if not i.flag & 2304]
        if len(flag) > 1:
            flag = [flag[flag.index(max(flag,
                                        key=lambda x: x[1].get_tag('AS')))]]
        assert len(flag) == 1
        pri_index, pri_read = flag[0]
        primary_reverse = bool(pri_read.flag & 16)
        seq = pri_read.get_forward_sequence()
        n_aligns = len(v)
        any_seq = False

        temp = []
        for index, a in enumerate(v):
            qstart, qend, qlen = ref_get_query_pos_from_cigartuples(a)
            align_reverse = bool(a.flag & 16)
            if primary_reverse != align_reverse:
                start_temp = qlen - qend
                qend = start_temp + qend - qstart
                qstart = start_temp
            pri = index == pri_index
            if not pri:
                no += 1
            else:
                yes += 1
                any_seq = len(seq) if seq else 0

            chrom = names[a.rname]
            start = a.reference_start + 1
            end = a.reference_end
            t = pd.Interval(start, end)
            if regions and chrom in regions and \
                    any(t.overlaps(q) for q in regions[chrom]):
                overlaps = 1
            else:
                overlaps = 0

            rd = {'qname': a.qname,
                  'n_alignments': n_aligns,
                  'chrom': chrom,
                  'rstart': start,
                  'rend': end,
                  'strand': '-' if align_reverse else '+',
                  'qstart': qstart,
                  'qend': qend,
                  'qlen': qlen,
                  'aln_size': qend - qstart,
                  'mapq': a.mapq,
                  'alignment_score': a.get_tag('AS'),
                  'seq': seq if pri else '',
                  'fslr_version': flsr_version,
                  'inferred_by_primer': 0,
                  }
            if regions:
                rd['overlaps_region'] = overlaps
            temp.append(rd)

        assert any_seq

        if len(temp) > 1:
            res += temp
            continue

        temp = sorted(temp, key=lambda r: r['qstart'])
        qstart_gap = temp[0]['qstart']
        qend_gap = temp[0]['qlen'] - temp[0]['qend']
        p_names = temp[0]['qname'].split('.')[-1].split('_')
        p1, p2 = [i.rstrip('FR') for i in p_names]

        if qstart_gap > 5 and qend_gap > 5:
            res += temp
            continue
        if p1 != 'False':
            temp[0]['n_alignments'] = 2
            p1_rd = {'qname': temp[0]['qname'],
                     'n_alignments': 2,
                     'chrom': p1,
                     'rstart': 0,
                     'rend': 0,
                     'strand': '-' if p_names[0][-1] == "R" else '+',
                     'qstart': 0,
                     'qend': len(primers[p1]),
                     'qlen': qlen,
                     'aln_size': 0,
                     'mapq': 0,
                     'alignment_score': 0,
                     'seq': '',
                     'fslr_version': flsr_version,
                     'inferred_by_primer': 1,
                     }
            temp = [p1_rd, temp[0]]
        elif p2 != 'False':
            temp[0]['n_alignments'] = 2
            p2_rd = {'qname': temp[0]['qname'],
                     'n_alignments': 2,
                     'chrom': p2,
                     'rstart': 0,
                     'rend': 0,
                     'strand': '-' if p_names[1][-1] == "R" else '+',
                     'qstart': qlen - len(primers[p2]),
                     'qend': qlen,
                     'qlen': qlen,
                     'aln_size': 0,
                     'mapq': 0,
                     'alignment_score': 0,
                     'seq': '',
                     'fslr_version': flsr_version,
                     'inferred_by_primer': 1,
                     }
            temp = [temp[0], p2_rd]
        res += temp

    df = pd.DataFrame.from_records(res).sort_values(['qname', 'qstart'])
    bad_anchors = []
    for grp, dd in df.groupby('qname'):
        aln_s = list(dd['aln_size'])
        if aln_s[0] < 50 or aln_s[-1] < 50:
            bad_anchors += [1] * len(dd)
        else:
            bad_anchors += [0] * len(dd)
    df['short_anchor<50bp'] = bad_anchors
    df = df.sort_values(['n_alignments', 'qname', 'qstart'],
                        ascending=[False, True, True])
    cols = ['chrom', 'rstart', 'rend', 'qname', 'n_alignments',
            'aln_size', 'qstart', 'qend', 'strand', 'mapq', 'qlen',
            'alignment_score', 'short_anchor<50bp', 'fslr_version',
            'inferred_by_primer', 'seq']
    if regions:
        cols.append('overlaps_region')
    return df[cols]


# ---------------------------------------------------------------------------
# random BAM generator
# ---------------------------------------------------------------------------

NAMES = ['chr1', 'chr2', 'chr3']
LENGTHS = [5_000_000, 5_000_000, 2_000_000]
PRIMERS = {'21q1': 'A' * 21, '17p6': 'C' * 23}
BASES = np.array(list('ACGT'))


def _rand_seq(rng, n):
    return ''.join(BASES[rng.integers(0, 4, n)])


def make_bam(path, rng, n_reads=40):
    labels = ['21q1F_17p6R', '17p6R_21q1F', 'False_17p6R', '21q1F_False',
              'False_False']
    records = []
    for i in range(n_reads):
        qlen = int(rng.integers(120, 3000))
        lab = labels[int(rng.integers(0, len(labels)))]
        qname = f'r{i:03d}.{rng.integers(0,99)}_{rng.integers(0,99)}.{lab}'
        n_aln = int(rng.integers(1, 6))
        # unique qstarts so the reference's unstable sorts are
        # deterministic on ties
        edges = np.sort(rng.choice(np.arange(1, qlen), 2 * n_aln,
                                   replace=False))
        spans = [(int(edges[2 * k]), int(edges[2 * k + 1]))
                 for k in range(n_aln)]
        if rng.random() < 0.4 and n_aln == 1:
            # exercise the inferred-primer branch: gap <= 5 at one end
            if rng.random() < 0.5:
                spans = [(int(rng.integers(0, 6)),
                          int(rng.integers(qlen // 2, qlen)))]
            else:
                spans = [(int(rng.integers(0, qlen // 2)),
                          qlen - int(rng.integers(0, 6)))]
        seq = _rand_seq(rng, qlen)
        pri_k = int(rng.integers(0, n_aln))
        multi_primary = rng.random() < 0.25
        for k, (qs, qe) in enumerate(spans):
            rev = bool(rng.random() < 0.5)
            rspan = max(1, int((qe - qs) * rng.uniform(0.7, 1.3)))
            tid = int(rng.integers(0, len(NAMES)))
            pos = int(rng.integers(0, LENGTHS[tid] - rspan - 10))
            is_pri = (k == pri_k) or multi_primary
            flag = (16 if rev else 0) | (0 if is_pri else 2304)
            # record coordinates are record-oriented: flip [qs, qe) when
            # the record is reverse, like a real aligner's SAM
            if rev:
                qs_r, qe_r = qlen - qe, qlen - qs
            else:
                qs_r, qe_r = qs, qe
            hard = (not is_pri) and rng.random() < 0.5
            cig = bamio.approx_cigar(qs_r, qe_r, qlen, rspan, hard)
            if hard:
                rseq = ''
            else:
                rseq = revcomp_str(seq) if rev else seq
                if cig[0][1] == 'S' or cig[-1][1] == 'S':
                    pass        # soft clips keep the full seq
            rec = bamio.BamRecord(
                qname=qname, flag=flag, ref_id=tid, pos=pos,
                mapq=int(rng.integers(0, 61)), cigar=cig,
                seq='' if hard else rseq,
                qual=None, tags={'AS': int(rng.integers(1, 2000))})
            records.append(rec)
    rng.shuffle(records)
    bamio.write_bam(path, NAMES, LENGTHS, records)
    return path


def _run_both(tmp_path, rng, regions=None):
    bam = make_bam(str(tmp_path / 'x.bam'), rng)
    regions_path = None
    regions_list = []
    if regions:
        regions_path = str(tmp_path / 'regions.bed')
        with open(regions_path, 'w') as fh:
            for (c, s, e) in regions:
                fh.write(f'{c}\t{s}\t{e}\n')
        regions_list = regions

    got = pd.DataFrame(
        mapping_table_from_bam(bam, regions_path, PRIMERS).to_dict())

    names, _lengths, records = bamio.open_bam(bam)
    shims = [ShimRecord(r) for r in records]
    import fslr_tpu
    want = ref_mapping_info(shims, names, regions_list, PRIMERS,
                            fslr_tpu.__version__)
    return got.reset_index(drop=True), want.reset_index(drop=True)


@pytest.mark.parametrize('seed', range(10))
def test_differential_mapping_table(seed, tmp_path):
    rng = np.random.default_rng(3000 + seed)
    got, want = _run_both(tmp_path, rng)
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


def test_differential_mapping_table_regions(tmp_path):
    rng = np.random.default_rng(4242)
    got, want = _run_both(tmp_path, rng, regions=[
        ('chr1', 100_000, 2_000_000), ('chr2', 0, 500_000)])
    pd.testing.assert_frame_equal(got, want, check_dtype=False)
