"""End-to-end pipeline test: synthetic genome + amplicon FASTQ -> artifacts.

Mini version of BASELINE.json config 2/3: fusion reads with shared
breakpoints must survive filtering, be split-aligned, and cluster; all
reference artifacts must be produced with their file contracts.
"""

import os

import numpy as np
import pandas as pd
import pytest

from fslr_tpu.config import PipelineConfig
from fslr_tpu.encode import decode, revcomp_str
from fslr_tpu.io import bam as bamio
from fslr_tpu.panel import load_panel
from fslr_tpu.pipeline import run_pipeline
from tests.oracles import random_seq

PANEL = load_panel().subset(['21q1', '17p6'])
CHROM_LEN = 2_000_000


@pytest.fixture(scope='module')
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp('pipe')
    rng = np.random.default_rng(77)
    chrA = random_seq(rng, CHROM_LEN)
    chrB = random_seq(rng, CHROM_LEN)
    ref_path = root / 'ref.fa'
    with open(ref_path, 'w') as fh:
        fh.write('>chrA\n' + decode(chrA) + '\n')
        fh.write('>chrB\n' + decode(chrB) + '\n')

    t21 = PANEL.targets['21q1']
    t17rc = revcomp_str(PANEL.targets['17p6'])

    def fusion_read(bpos):
        return (t21 + decode(chrA[1_000_000:1_000_800])
                + decode(chrB[bpos:bpos + 1000])
                + decode(chrA[1_200_000:1_200_800]) + t17rc)

    reads = []
    for i in range(4):
        reads.append((f'g1r{i}', fusion_read(1_000_000)))
    # keep g2's interior interval > 500kb from both chromosome ends, or
    # the subtelomere mask (correctly) drops it
    for i in range(3):
        reads.append((f'g2r{i}', fusion_read(1_200_000)))
    # singleton with only the start primer (exercises pseudo-primer path)
    reads.append(('single0', t21 + decode(chrA[1_500_000:1_500_900])))
    # junk read dropped by the filter
    reads.append(('junky', decode(random_seq(rng, 300)) + 'AT' * 200
                  + decode(random_seq(rng, 300))))

    fq_dir = root / 'reads'
    fq_dir.mkdir()
    with open(fq_dir / 'batch0.fastq', 'w') as fh:
        for name, seq in reads:
            fh.write(f'@{name}\n{seq}\n+\n{"I" * len(seq)}\n')
    return root, str(ref_path), str(fq_dir)


def test_pipeline_end_to_end(workdir):
    root, ref_path, fq_dir = workdir
    out = str(root / 'out')
    config = PipelineConfig(name='T', out=out, ref=ref_path,
                            primers=('21q1', '17p6'), basecalled=fq_dir)
    run_pipeline(config, backend='jax')

    basename = os.path.join(out, 'T')
    # --- artifacts exist ---
    for suffix in ('.bwa_dodi.bam', '.mappings.bed',
                   '.filter_counts_summary.csv', '.without_primers.fq',
                   '.mappings.cluster.bed', '.mappings.representative.bed'):
        assert os.path.exists(basename + suffix), suffix

    # --- filter counts ---
    with open(basename + '.filter_counts_summary.csv') as fh:
        lines = fh.read().splitlines()
    assert lines[0] == 'Filter counts:'
    counts = dict(zip(lines[1].split(','), lines[2].split(',')))
    assert counts['name'] == 'T'
    assert counts['total_kept'] == '8'
    assert counts['junk_seqs_dropped'] == '1'
    assert counts['21q1F_17p6R'] == '7'
    assert counts['21q1F_False'] == '1'

    # --- mappings.bed ---
    bed = pd.read_csv(basename + '.mappings.bed', sep='\t')
    assert list(bed.columns) == [
        'chrom', 'rstart', 'rend', 'qname', 'n_alignments', 'aln_size',
        'qstart', 'qend', 'strand', 'mapq', 'qlen', 'alignment_score',
        'short_anchor<50bp', 'fslr_version', 'inferred_by_primer', 'seq']
    fusion_rows = bed[bed['qname'].str.startswith('g1r0')]
    assert len(fusion_rows) == 3
    assert list(fusion_rows['chrom']) == ['chrA', 'chrB', 'chrA']
    single_rows = bed[bed['qname'].str.startswith('single0')]
    assert len(single_rows) == 2           # genomic + inferred 21q1 pseudo
    assert (single_rows['inferred_by_primer'] == 1).sum() == 1
    assert '21q1' in set(single_rows['chrom'])

    # --- BAM round-trip ---
    names, lengths, records = bamio.read_bam(basename + '.bwa_dodi.bam')
    assert names == ['chrA', 'chrB']
    assert lengths == [CHROM_LEN, CHROM_LEN]
    primaries = [r for r in records if not r.flag & 2304]
    by_q = {}
    for r in primaries:
        by_q.setdefault(r.qname, []).append(r)
    assert all(len(v) == 1 for v in by_q.values())
    pri = by_q[[q for q in by_q if q.startswith('g1r0')][0]][0]
    assert pri.seq != ''
    assert pri.infer_read_length() == len(pri.seq)
    # coordinate sorted
    keyed = [(r.ref_id, r.pos) for r in records]
    assert keyed == sorted(keyed)

    # --- clustering ---
    cb = pd.read_csv(basename + '.mappings.cluster.bed', sep='\t')
    g1 = set(cb[cb['qname'].str.startswith('g1')]['cluster'])
    g2 = set(cb[cb['qname'].str.startswith('g2')]['cluster'])
    assert len(g1) == 1 and len(g2) == 1 and g1 != g2
    assert set(cb[cb['qname'].str.startswith('g1')]['n_reads']) == {4}
    assert set(cb[cb['qname'].str.startswith('g2')]['n_reads']) == {3}
    rep = pd.read_csv(basename + '.mappings.representative.bed', sep='\t')
    # one representative read per cluster (incl. singleton clusters)
    assert rep.groupby('cluster')['qname'].nunique().eq(1).all()


def test_pipeline_exact_cigars(workdir):
    """Primary CIGARs come from the traceback kernel: exact reads map as
    pure soft-clip + match blocks."""
    root, ref_path, fq_dir = workdir
    out = str(root / 'out')
    names, lengths, records = bamio.read_bam(
        os.path.join(out, 'T.bwa_dodi.bam'))
    pri = [r for r in records if not r.flag & 2304
           and r.qname.startswith('g1r0')][0]
    m_runs = [(n, op) for n, op in pri.cigar if op == 'M']
    assert len(m_runs) == 1               # exact segment: single M run
    assert not any(op in 'ID' for _, op in pri.cigar)
    assert sum(n for n, op in pri.cigar if op in 'MIS') == len(pri.seq)


def test_pipeline_consensus_stage(workdir):
    root, ref_path, fq_dir = workdir
    out = str(root / 'out_cons')
    config = PipelineConfig(name='C', out=out, ref=ref_path,
                            primers=('21q1', '17p6'), basecalled=fq_dir,
                            run_consensus=True)
    run_pipeline(config, backend='jax')
    base = os.path.join(out, 'C')
    cons_fa = os.path.join(out, 'cluster', 'C.cluster.consensus.fa')
    assert os.path.exists(cons_fa)
    from fslr_tpu.io.fastq import read_fastx
    cons = list(read_fastx(cons_fa))
    assert len(cons) == 2                  # two clusters
    assert cons[0].name.startswith('cluster:')
    # identical members -> consensus == member sequence (trimmed read)
    bed = pd.read_csv(base + '.mappings.bed', sep='\t')
    g1seq = bed[(bed['qname'].str.startswith('g1r0'))
                & (bed['seq'].astype(str).str.len() > 1)]['seq'].iloc[0]
    n4 = [c for c in cons if 'n_reads:4' in c.name][0]
    assert n4.sequence == g1seq
    # purity CSV (README.rst:137): cluster id, n_reads, consensus, and the
    # proportion of member reads carrying each panel primer
    purity = pd.read_csv(os.path.join(out, 'cluster',
                                      'C.cluster.purity.csv'))
    assert list(purity.columns) == ['cluster', 'n_reads', 'consensus',
                                    '21q1_proportion', '17p6_proportion']
    assert len(purity) == 2
    assert set(purity['n_reads']) == {4, 3}
    # every clustered read here was labelled 21q1F_17p6R
    assert (purity['21q1_proportion'] == 1.0).all()
    assert (purity['17p6_proportion'] == 1.0).all()
    assert (purity['consensus'].astype(str).str.len() > 100).all()
    # merged artifacts
    assert os.path.exists(base + '.bwa_dodi_merged.bam')
    merged = pd.read_csv(base + '.mappings_merged.bed', sep='\t')
    assert merged['qname'].str.startswith('cluster:').any()
    # clustered originals removed from the merged table
    assert not merged['qname'].str.startswith('g1r').any()
    _, _, mrecords = bamio.read_bam(base + '.bwa_dodi_merged.bam')
    assert any(r.qname.startswith('cluster:') for r in mrecords)
    assert not any(r.qname.startswith('g1r') for r in mrecords)


def test_pipeline_skip_alignment_resume(workdir):
    root, ref_path, fq_dir = workdir
    out = str(root / 'out')
    config = PipelineConfig(name='T', out=out, ref=ref_path,
                            primers=('21q1', '17p6'), basecalled=fq_dir,
                            skip_alignment=True)
    # resume from existing mappings.bed + bam (reference main.py:76,190)
    run_pipeline(config, backend='jax')
    assert os.path.exists(os.path.join(out, 'T.mappings.cluster.bed'))


def test_unknown_primer_raises(workdir):
    root, ref_path, fq_dir = workdir
    config = PipelineConfig(name='X', out=str(root / 'out2'), ref=ref_path,
                            primers=('nope',), basecalled=fq_dir)
    with pytest.raises(ValueError):
        run_pipeline(config, backend='jax')


def test_pipeline_masked_reference_and_multifile(tmp_path):
    """--reference-mask double mapping + multiple input files + regions."""
    rng = np.random.default_rng(99)
    chrA = random_seq(rng, 300_000)
    ref_path = tmp_path / 'ref.fa'
    with open(ref_path, 'w') as fh:
        fh.write('>chrA\n' + decode(chrA) + '\n')
    mask_bed = tmp_path / 'mask.bed'
    mask_bed.write_text('chrA\t100000\t140000\n')
    regions_bed = tmp_path / 'regions.bed'
    regions_bed.write_text('chrA\t110000\t130000\n')

    t21 = PANEL.targets['21q1']
    t17rc = revcomp_str(PANEL.targets['17p6'])
    fq_dir = tmp_path / 'reads'
    fq_dir.mkdir()
    for f in range(2):
        with open(fq_dir / f'b{f}.fastq', 'w') as fh:
            for i in range(3):
                seq = t21 + decode(chrA[115_000:116_200]) + t17rc
                fh.write(f'@f{f}r{i}\n{seq}\n+\n{"I" * len(seq)}\n')
    out = str(tmp_path / 'out')
    config = PipelineConfig(name='M', out=out, ref=str(ref_path),
                            primers=('21q1', '17p6'),
                            basecalled=str(fq_dir),
                            reference_mask=str(mask_bed),
                            regions=str(regions_bed),
                            skip_clustering=True)
    run_pipeline(config, backend='jax')
    bed = pd.read_csv(os.path.join(out, 'M.mappings.bed'), sep='\t')
    assert len(set(bed['qname'].str.split('.').str[0])) == 6  # both files
    assert 'overlaps_region' in bed.columns
    genomic = bed[bed['inferred_by_primer'] == 0]
    assert (genomic['overlaps_region'] == 1).all()
    assert (genomic['chrom'] == 'chrA').all()
    # masked temp ref cleaned up
    assert not glob_temp(out)


def glob_temp(out):
    import glob as g
    return g.glob(os.path.join(out, '*_temp_ref.fa*'))


def test_pipeline_streamed_chunks_byte_identical(workdir):
    """The streamed align loop (align_stream_reads chunks) must produce
    byte-identical artifacts to the wide run (config default covers the
    whole dataset in one chunk)."""
    import dataclasses

    root, ref_path, fq_dir = workdir
    out = str(root / 'out')            # artifacts from the wide run
    out_s = str(root / 'out_stream')
    config = PipelineConfig(name='T', out=out_s, ref=ref_path,
                            primers=('21q1', '17p6'), basecalled=fq_dir)
    config = config.replace(batch=dataclasses.replace(
        config.batch, align_stream_reads=3))   # 8 kept reads -> 3 chunks
    run_pipeline(config, backend='jax')
    for suffix in ('.bwa_dodi.bam', '.mappings.bed',
                   '.mappings.cluster.bed', '.mappings.representative.bed',
                   '.filter_counts_summary.csv'):
        with open(os.path.join(out, 'T' + suffix), 'rb') as fh:
            wide = fh.read()
        with open(os.path.join(out_s, 'T' + suffix), 'rb') as fh:
            streamed = fh.read()
        assert wide == streamed, f'{suffix} differs between streamed/wide'


def test_mapping_table_from_bam_roundtrip(workdir):
    """The standalone BAM -> mappings.bed re-extraction
    (collect_mapping_info.py:184-191 mode) must rebuild the pipeline's
    own bed exactly from its own BAM — minus the inferred-primer
    pseudo-rows' seq column semantics, which are identical anyway."""
    from fslr_tpu.stages.mapping_table import mapping_table_from_bam
    root, ref_path, fq_dir = workdir
    basename = os.path.join(str(root / 'out'), 'T')
    bam = basename + '.bwa_dodi.bam'
    bed = basename + '.mappings.bed'
    if not os.path.exists(bam):        # fixture test didn't run first
        pytest.skip('pipeline artifacts missing')
    want = pd.read_csv(bed, sep='\t')
    got = pd.DataFrame(mapping_table_from_bam(bam, None, PANEL.seqs)
                       .to_dict())
    # the bed round-trips through to_csv: normalize the same way
    import io as _io
    buf = _io.StringIO()
    got.to_csv(buf, index=False, sep='\t')
    buf.seek(0)
    got2 = pd.read_csv(buf, sep='\t')
    pd.testing.assert_frame_equal(
        want.sort_values(['qname', 'qstart', 'chrom'])
        .reset_index(drop=True),
        got2.sort_values(['qname', 'qstart', 'chrom'])
        .reset_index(drop=True))


def test_pipeline_procs_threadpool_parity(workdir, tmp_path):
    """--procs > 1 fans the per-file filter/primer loops over a host
    thread pool (the reference's Pool.map, main.py:95-114); artifacts
    and counters must be identical to the serial path.  Two input files
    so the pool genuinely runs concurrent jobs."""
    root, ref_path, fq_dir = workdir
    # split the single batch file into two
    import shutil
    fq2 = tmp_path / 'reads2'
    fq2.mkdir()
    lines = open(os.path.join(fq_dir, 'batch0.fastq')).read().splitlines()
    recs = [lines[i:i + 4] for i in range(0, len(lines), 4)]
    half = len(recs) // 2
    with open(fq2 / 'a.fastq', 'w') as fh:
        fh.write('\n'.join(l for r in recs[:half] for l in r) + '\n')
    with open(fq2 / 'b.fastq', 'w') as fh:
        fh.write('\n'.join(l for r in recs[half:] for l in r) + '\n')

    outs = {}
    for procs in (1, 2):
        out = str(tmp_path / f'out_p{procs}')
        config = PipelineConfig(name='T', out=out, ref=ref_path,
                                primers=('21q1', '17p6'),
                                basecalled=str(fq2), procs=procs)
        run_pipeline(config, backend='jax')
        outs[procs] = out

    for suffix in ('.mappings.bed', '.mappings.cluster.bed',
                   '.mappings.representative.bed',
                   '.filter_counts_summary.csv', '.without_primers.fq'):
        a = open(os.path.join(outs[1], 'T' + suffix), 'rb').read()
        b = open(os.path.join(outs[2], 'T' + suffix), 'rb').read()
        assert a == b, suffix
