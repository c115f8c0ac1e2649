"""Mapping-table extraction: alignments -> ``{name}.mappings.bed``.

Vectorized replication of the reference collect_mapping_info
(/root/reference/fslr/collect_mapping_info.py):

  * per-read grouping; primary = the single designated primary (the
    reference picks max AS when dodi leaves several, :42-48 — our aligner
    designates exactly one, same outcome);
  * query coordinates from CIGAR clips (:7-16) are our record-orientation
    (qstart_o, qend_o, qlen); alignments on the opposite strand from the
    primary are flipped onto the primary strand (:58-62);
  * rstart is 1-based (reference_start + 1), rend is the 1-based inclusive
    end (pysam reference_end), :70-72;
  * ``overlaps_region`` flag vs --regions bed (:28-36, 74-77, 96-97);
  * single-alignment reads with a primer label and <= 5 bp gap at one end
    get an inferred primer pseudo-alignment (chrom = primer name,
    n_alignments = 2, inferred_by_primer = 1), :105-158;
  * ``short_anchor<50bp`` flags reads whose first/last alignment (by
    qstart) spans < 50 bp (:164-172);
  * output TSV sorted by n_alignments desc, qname, qstart, with the exact
    reference column order (:174-181).
"""

from __future__ import annotations

import numpy as np

import fslr_tpu
from fslr_tpu.stages.align import Alignments
from fslr_tpu.table import Table, write_tsv

COLUMNS = ['chrom', 'rstart', 'rend', 'qname', 'n_alignments', 'aln_size',
           'qstart', 'qend', 'strand', 'mapq', 'qlen', 'alignment_score',
           'short_anchor<50bp', 'fslr_version', 'inferred_by_primer', 'seq']


def build_regions(regions_path):
    regions = {}
    if not regions_path:
        return regions
    with open(regions_path) as fh:
        for line in fh:
            f = line.strip().split('\t')
            if len(f) < 3:
                continue
            regions.setdefault(f[0], []).append((int(f[1]), int(f[2])))
    return regions


def _overlaps(regions, chrom, start, end):
    """Interval overlap as the reference's pandas.Interval (closed='right'):
    (a, b] vs (c, d] intersect iff a < d and c < b."""
    for (s, e) in regions.get(chrom, ()):
        if start < e and s < end:
            return True
    return False


def mapping_table(aln: Alignments, qnames: list[str], seqs: list[str],
                  chrom_names: list[str], regions_path: str | None,
                  primers: dict[str, str]) -> Table:
    """Build the mappings table.  ``qnames``/``seqs`` are indexed by
    aln.read_idx; ``primers`` maps primer name -> primer_seq (20 bp)."""
    version = fslr_tpu.__version__
    regions = build_regions(regions_path)
    n = len(aln)

    cols = COLUMNS + (['overlaps_region'] if regions else [])
    if n == 0:
        return Table({c: np.zeros(0, object) for c in cols})

    # ---- vectorized per-alignment columns ------------------------------
    ridx = aln.read_idx.astype(np.int64)
    uniq, inv, counts = np.unique(ridx, return_inverse=True,
                                  return_counts=True)
    pris = np.flatnonzero(aln.is_primary)
    pri_reads = ridx[pris]
    ps = np.argsort(pri_reads)
    if len(pris) != len(uniq) or np.any(pri_reads[ps] != uniq):
        raise RuntimeError('primary flag problem: reads without exactly '
                           'one primary alignment')
    pri_per_aln = pris[ps][inv]          # primary alignment index per row
    pri_rev = aln.strand_rev[pri_per_aln]
    n_aligns = counts[inv]
    qlen = aln.qlen.astype(np.int64)
    qs_o = aln.qstart_o.astype(np.int64)
    qe_o = aln.qend_o.astype(np.int64)
    # flip onto the primary strand (collect_mapping_info.py:58-62)
    flip = pri_rev != aln.strand_rev
    qstart = np.where(flip, qlen - qe_o, qs_o)
    qend = np.where(flip, qlen - qs_o, qe_o)
    rstart = aln.rstart.astype(np.int64) + 1
    rend = aln.rend.astype(np.int64) + 1
    chrom_col = np.array(list(chrom_names), object)[aln.chrom_idx]
    strand_col = np.where(aln.strand_rev, '-', '+')
    # BAM SEQ is 4-bit coded, so pysam get_forward_sequence (the
    # reference's seq source, collect_mapping_info.py:51) is always
    # uppercase even though the pipeline carries tantan-masked
    # lowercase through the FASTQ stages.
    seq_col = np.full(n, '', object)
    for i in pris:
        seq_col[i] = seqs[int(ridx[i])].upper()
    qname_col = np.array([qnames[int(r)] for r in ridx], object)
    cols_all = {
        'qname': qname_col, 'n_alignments': n_aligns, 'chrom': chrom_col,
        'rstart': rstart, 'rend': rend, 'strand': strand_col,
        'qstart': qstart, 'qend': qend, 'qlen': qlen,
        'aln_size': qend - qstart, 'mapq': aln.mapq.astype(np.int64),
        'alignment_score': aln.score.astype(np.int64), 'seq': seq_col,
        'fslr_version': np.full(n, version, object),
        'inferred_by_primer': np.zeros(n, np.int64),
    }
    if regions:
        cols_all['overlaps_region'] = np.array(
            [int(_overlaps(regions, chrom_col[i], int(rstart[i]),
                           int(rend[i]))) for i in range(n)], np.int64)

    multi = n_aligns > 1
    parts = [Table({k: v[multi] for k, v in cols_all.items()})]

    # ---- single-alignment reads: inferred primer pseudo-alignments
    # ('missing bread', collect_mapping_info.py:109-158), vectorized —
    # the per-singleton dict loop dominated this stage at 1M reads ------
    singles = np.flatnonzero(~multi)
    if len(singles):
        sd = {k: v[singles] for k, v in cols_all.items()}
        qn = [str(q) for q in sd['qname'].tolist()]
        labels = [q.rsplit('.', 1)[-1].split('_') for q in qn]
        l1 = [lab[0] for lab in labels]
        l2 = [lab[1] if len(lab) > 1 else None for lab in labels]
        p1 = np.array([x.rstrip('FR') for x in l1], object)
        p2 = np.array([x.rstrip('FR') if x is not None else None
                       for x in l2], object)
        ql = sd['qlen']
        qstart_gap = sd['qstart']
        qend_gap = ql - sd['qend']
        both_gaps = (qstart_gap > 5) & (qend_gap > 5)
        m1 = (~both_gaps) & (p1 != 'False')
        m2 = (~both_gaps) & ~m1 & (p2 != 'False')
        na = sd['n_alignments'].copy()
        na[m1 | m2] = 2
        sd['n_alignments'] = na
        plen = {k: len(v) for k, v in primers.items()}

        def _pseudo(mask, which):
            idx = np.flatnonzero(mask)
            if not len(idx):
                return None
            pser = (p1 if which == 1 else p2)[idx]
            lser = [(l1 if which == 1 else l2)[i] for i in idx]
            n = len(idx)
            plens = np.array([plen[x] for x in pser], np.int64)
            d = {'qname': np.array(qn, object)[idx],
                 'n_alignments': np.full(n, 2, np.int64),
                 'chrom': pser,
                 'rstart': np.zeros(n, np.int64),
                 'rend': np.zeros(n, np.int64),
                 'strand': np.array(['-' if x[-1] == 'R' else '+'
                                     for x in lser], object),
                 'qstart': (np.zeros(n, np.int64) if which == 1
                            else ql[idx] - plens),
                 'qend': (plens if which == 1 else ql[idx]),
                 'qlen': ql[idx], 'aln_size': np.zeros(n, np.int64),
                 'mapq': np.zeros(n, np.int64),
                 'alignment_score': np.zeros(n, np.int64),
                 'seq': np.full(n, '', object),
                 'fslr_version': np.full(n, version, object),
                 'inferred_by_primer': np.ones(n, np.int64)}
            if regions:
                # the reference builds pseudo-rows WITHOUT the
                # overlaps_region key (collect_mapping_info.py:124-158),
                # so from_records leaves NaN and the whole column turns
                # float64 ("1.0"/"" in the TSV) — replicated quirk
                d['overlaps_region'] = np.full(n, np.nan)
            return Table(d)

        # concat order preserves the reference's tie order under the
        # stable (qname, qstart) sort: start pseudos BEFORE their read's
        # real row, end pseudos AFTER
        pre = _pseudo(m1, 1)
        post = _pseudo(m2, 2)
        if pre is not None:
            parts.append(pre)
        parts.append(Table(sd))
        if post is not None:
            parts.append(post)
    df = Table.concat(parts) if len(parts) > 1 else parts[0]
    df = df.sort(['qname', 'qstart'])

    # short-anchor flag: first/last alignment (by qstart) spans < 50 bp
    # (collect_mapping_info.py:164-172); group-start/end extraction over
    # the (qname, qstart)-sorted frame replaces the per-qname groupby loop
    qn = df['qname']
    sizes = df['aln_size']
    starts_m = np.ones(len(df), bool)
    starts_m[1:] = qn[1:] != qn[:-1]
    ends_m = np.empty(len(df), bool)
    ends_m[:-1] = starts_m[1:]
    ends_m[-1] = True
    gidx = np.cumsum(starts_m) - 1
    bad = (sizes[starts_m] < 50) | (sizes[ends_m] < 50)
    df['short_anchor<50bp'] = bad[gidx].astype(np.int64)

    df = df.sort(['n_alignments', 'qname', 'qstart'], [False, True, True])
    return df.select(cols)


def write_mappings_bed(df: Table, path: str):
    write_tsv(df, path)


def _clip_query_span(cigar: list[tuple[int, str]]):
    """(qstart, qend, qlen) from CIGAR clips, hard clips included —
    the reference's get_query_pos_from_cigartuples
    (/root/reference/fslr/collect_mapping_info.py:7-16)."""
    qlen = sum(n for n, op in cigar if op in 'MIS=XH')
    start = 0
    end = qlen
    if cigar and cigar[0][1] in 'SH':
        start += cigar[0][0]
    if cigar and cigar[-1][1] in 'SH':
        end -= cigar[-1][0]
    return start, end, qlen


def mapping_table_from_bam(bam_path: str, regions_path: str | None = None,
                           primers: dict[str, str] | None = None
                           ) -> Table:
    """Rebuild the mappings table from ANY coordinate/name-ordered BAM —
    the reference's standalone ``collect_mapping_info --bam --out`` mode
    (/root/reference/fslr/collect_mapping_info.py:184-191).

    Streams records through io/bam.open_bam, derives query coordinates
    from CIGAR clips (:7-16), designates the primary among non-secondary/
    non-supplementary records by max AS on ties (:42-44, the dodi
    primary-flag workaround), takes the primary's forward sequence, and
    reuses the production table builder for the flip/inferred-primer/
    short-anchor/sort contract — so a pipeline-produced BAM round-trips
    to an identical bed (tested in tests/test_mapping_table.py)."""
    from fslr_tpu.io import bam as bamio
    from fslr_tpu.encode import revcomp_str
    from fslr_tpu.stages.align import Alignments

    names, _lengths, records = bamio.open_bam(bam_path)
    gid: dict[str, int] = {}
    qnames: list[str] = []
    seqs: list[str] = []
    by_read: list[list] = []        # rows: [ref_id, pos, rend0, flag,
                                    #        qs, qe, qlen, mapq, AS, pri?]
    pri_cand: list[list] = []       # per read: (order, AS, row#) of
                                    # primary-eligible records
    for a in records:
        if a.flag & 4:
            continue
        g = gid.setdefault(a.qname, len(gid))
        if g == len(qnames):
            qnames.append(a.qname)
            seqs.append('')
            by_read.append([])
            pri_cand.append([])
        qs, qe, qlen = _clip_query_span(a.cigar)
        rows = by_read[g]
        if not a.flag & 2304:
            pri_cand[g].append((a.tags.get('AS', 0), len(rows),
                                a.seq, bool(a.flag & 16)))
        rows.append([a.ref_id, a.pos,
                     a.pos + max(a.reference_span(), 1) - 1,
                     bool(a.flag & 16), qs, qe, qlen, a.mapq,
                     a.tags.get('AS', 0)])

    cols = {k: [] for k in ('read_idx', 'chrom_idx', 'rstart', 'rend',
                            'strand_rev', 'qstart_o', 'qend_o', 'qlen',
                            'score', 'mapq', 'is_primary')}
    for g, rows in enumerate(by_read):
        cands = pri_cand[g]
        if not cands:
            raise ValueError(
                f'{bam_path}: read {qnames[g]} has no primary-eligible '
                f'alignment (all records secondary/supplementary)')
        # first max AS wins (reference max() semantics, :42-44)
        best = max(cands, key=lambda t: t[0])
        pri_row = best[1]
        seq, rev = best[2], best[3]
        seqs[g] = revcomp_str(seq) if rev else seq     # forward sequence
        for ri, row in enumerate(rows):
            cols['read_idx'].append(g)
            cols['chrom_idx'].append(row[0])
            cols['rstart'].append(row[1])
            cols['rend'].append(row[2])
            cols['strand_rev'].append(row[3])
            cols['qstart_o'].append(row[4])
            cols['qend_o'].append(row[5])
            cols['qlen'].append(row[6])
            cols['mapq'].append(row[7])
            cols['score'].append(row[8])
            cols['is_primary'].append(ri == pri_row)

    n = len(cols['read_idx'])
    aln = Alignments(
        read_idx=np.array(cols['read_idx'], np.int32),
        chrom_idx=np.array(cols['chrom_idx'], np.int32),
        rstart=np.array(cols['rstart'], np.int32),
        rend=np.array(cols['rend'], np.int32),
        strand_rev=np.array(cols['strand_rev'], bool),
        qstart_o=np.array(cols['qstart_o'], np.int32),
        qend_o=np.array(cols['qend_o'], np.int32),
        qlen=np.array(cols['qlen'], np.int32),
        score=np.array(cols['score'], np.int32),
        mapq=np.array(cols['mapq'], np.int32),
        is_primary=np.array(cols['is_primary'], bool),
        overlaps_region=np.zeros(n, bool),
    )
    if primers is None:
        from fslr_tpu.panel import load_panel
        primers = load_panel().seqs
    return mapping_table(aln, qnames, seqs, names, regions_path, primers)


def _main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        prog='python -m fslr_tpu.stages.mapping_table',
        description='Rebuild a mappings.bed from a BAM (the reference '
                    'collect_mapping_info standalone mode).')
    ap.add_argument('bam', help='BAM file to assess')
    ap.add_argument('out', help='output bed/TSV path')
    ap.add_argument('--regions', default=None,
                    help='bed of regions for the overlaps_region column')
    args = ap.parse_args(argv)
    df = mapping_table_from_bam(args.bam, args.regions)
    write_mappings_bed(df, args.out)
    print('Done')


if __name__ == '__main__':
    _main()
