"""Pipeline orchestrator — the fslr ``pipeline()`` equivalent.

Stage sequencing, counters, and file contract replicate
/root/reference/fslr/main.py:41-372:

  inputs glob (main.py:85-87) -> junk filter fan-out (:95-101) -> primer
  ID (:103-114) -> no-primer concatenation (:118-119) -> alignment +
  selection [+ masked-reference double mapping] (:121-171) ->
  {name}.bwa_dodi.bam + {name}.mappings.bed (:180-183) ->
  filter_counts_summary.csv (:185-188) -> clustering block (:190-352) ->
  {name}.mappings.cluster.bed / {name}.mappings.representative.bed.

Differences by design (documented divergences):
  * per-file fan-out runs serially on the host — parallelism lives on the
    device (batched kernels) and across hosts (parallel/mesh.py), not in a
    multiprocessing.Pool; --procs is accepted for CLI compatibility;
  * the masked-reference build overlaps filtering on a thread, mirroring
    the reference's background Process (main.py:78-82);
  * counters are plain dicts merged deterministically (the reference's
    Manager dict ordering depends on worker timing).
"""

from __future__ import annotations

import glob
import os
import sys
import threading

import numpy as np

from fslr_tpu.config import PipelineConfig
from fslr_tpu.instrument import StageTimer
from fslr_tpu.index import reference as refmod
from fslr_tpu.io import bam as bamio
from fslr_tpu.io.fastq import glob_input_files, read_reads
from fslr_tpu.panel import load_panel
from fslr_tpu.stages import (align as align_stage, cluster as cluster_stage,
                             filter_junk, find_primers, mapping_table)
from fslr_tpu.table import Table, read_tsv, write_tsv


def _load_indexed(path: str, k: int):
    ref = refmod.load_reference(path)
    cache = f'{path}.fslr_k{k}.npz'
    try:
        cache_fresh = os.path.exists(cache) and os.path.getmtime(cache) >= \
            os.path.getmtime(path)
        if cache_fresh:
            z = np.load(cache)
            if 'shard_bounds' in z:
                shards = []
                for si, (c0, c1) in enumerate(z['shard_bounds']):
                    sref = refmod.sub_reference(ref, int(c0), int(c1))
                    shards.append(refmod.IndexShard(
                        ref=sref, contig_base=int(c0),
                        sidx=refmod.SeedIndex(
                            k=k, counts=z[f'counts_{si}'],
                            positions=z[f'positions_{si}'])))
                sidx = refmod.SeedIndex(
                    k=k, counts=np.zeros(0, np.int64),
                    positions=np.zeros(0, np.int32), shards=shards)
            else:
                sidx = refmod.SeedIndex(k=k, counts=z['counts'],
                                        positions=z['positions'])
            return ref, sidx
    except Exception as e:
        # A corrupt/unreadable index cache silently rebuilding can mask
        # real bugs (truncated write, version skew) — be loud about it.
        print(f'WARNING: seed-index cache {cache} unreadable '
              f'({type(e).__name__}: {e}); rebuilding from {path}',
              file=sys.stderr)
    sidx = refmod.build_seed_index(ref, k)
    try:
        if sidx.shards:
            arrs = {'shard_bounds': np.array(
                [(sh.contig_base, sh.contig_base + len(sh.ref.names))
                 for sh in sidx.shards], np.int64)}
            for si, sh in enumerate(sidx.shards):
                arrs[f'counts_{si}'] = sh.sidx.counts
                arrs[f'positions_{si}'] = sh.sidx.positions
            np.savez(cache, **arrs)
        else:
            np.savez(cache, counts=sidx.counts, positions=sidx.positions)
    except Exception as e:
        print(f'WARNING: could not write seed-index cache {cache} '
              f'({type(e).__name__}: {e}); next run will rebuild',
              file=sys.stderr)
    return ref, sidx


def _merge_existing(dst: dict, src: dict):
    """Stage-A merge: only pre-initialised keys accumulate
    (filter_junk_from_fq.py:179-182)."""
    for k, v in src.items():
        if k in dst:
            dst[k] += v


def _merge_all(dst: dict, src: dict):
    """Stage-B merge: new keys are created (find_reads_with_primers
    func, :125-128)."""
    for k, v in src.items():
        if k not in dst:
            dst[k] = 0
        dst[k] += v


def run_pipeline(config: PipelineConfig, backend: str | None = None,
                 mesh=None):
    """Run the full pipeline.

    ``mesh``: optional ``jax.sharding.Mesh`` — when given, every batched
    stage kernel (filter, primer, seeding, extension, selection) runs
    data-parallel over its devices and counters reduce with psum
    (parallel/dispatch.py); artifacts are byte-identical to a
    single-device run (tests/test_parallel.py).

    ``config.n_processes > 1``: multi-HOST mode (SURVEY section 5.8).
    Each process is launched with its own ``process_id`` and the shared
    ``coordinator`` address, runs filter->primer->align on its input-file
    shard (the reference's Pool-over-files analog, main.py:95-114),
    counters are reduced across processes with a collective, and process
    0 merges the per-process beds/BAMs and runs clustering.  Artifacts
    equal a single-process run (tests/test_multiprocess.py)."""
    from fslr_tpu.parallel import dispatch
    with dispatch.use_mesh(mesh):
        if config.n_processes > 1:
            return _run_pipeline_multihost(config, backend)
        return _run_pipeline(config, backend)


def _read_counts_csv(path: str) -> dict:
    with open(path) as fh:
        lines = [ln.rstrip('\n') for ln in fh]
    keys = lines[1].split(',')
    vals = lines[2].split(',')
    out = {}
    for k, v in zip(keys, vals):
        out[k] = v if k == 'name' else int(v)
    return out


def _allreduce_counts(counts: dict) -> dict:
    """Global counter reduction across jax.distributed processes: each
    process contributes its local dict (keys differ — per-label combo
    counters appear only where seen), payloads are gathered with a
    cross-process collective and summed."""
    import json

    import jax
    if jax.process_count() <= 1:
        return dict(counts)
    from jax.experimental import multihost_utils
    payload = json.dumps({k: v for k, v in counts.items()
                          if k != 'name'}).encode()
    CAP = 1 << 14
    if len(payload) > CAP:
        raise ValueError('counter payload exceeds gather cap')
    arr = np.zeros(CAP, np.uint8)
    arr[:len(payload)] = np.frombuffer(payload, np.uint8)
    gathered = np.asarray(multihost_utils.process_allgather(arr))
    merged: dict = {}
    for row in gathered:
        raw = bytes(row.tobytes()).rstrip(b'\x00')
        for k, v in json.loads(raw).items():
            merged[k] = merged.get(k, 0) + v
    return merged


def _merge_bams_streamed(parts: list[str], out_path: str):
    """N-way streamed merge of coordinate-sorted per-process BAMs
    (samtools merge role) — raw payload copies, constant memory."""
    import heapq
    streams = [bamio.stream_raw_records(p) for p in parts]
    names, lengths = streams[0][0], streams[0][1]
    for nm, _l, _it in streams[1:]:
        if nm != names:
            raise ValueError('per-process BAM headers differ')

    def _items(it):
        for pl, _qn, rid, pos, rend in it:
            yield (rid if rid >= 0 else 1 << 30), pos, rend, rid, pl

    merged = heapq.merge(*(_items(s[2]) for s in streams),
                         key=lambda t: (t[0], t[1]))
    bamio.write_bam_items(out_path, names, lengths,
                          ((rid, pos, rend, pl)
                           for (_k, pos, rend, rid, pl) in merged),
                          sort_by_coord=False, write_index=True)


def _run_pipeline_multihost(config: PipelineConfig,
                            backend: str | None = None):
    import jax
    pid, nproc = config.process_id, config.n_processes
    from fslr_tpu.parallel.cluster_merge import initialize_distributed
    initialize_distributed(config.coordinator, nproc, pid)
    from jax.experimental import multihost_utils

    part_name = f'{config.name}__p{pid}'
    stage_cfg = config.replace(name=part_name, n_processes=1,
                               process_id=0, skip_clustering=True)
    _run_pipeline(stage_cfg, backend, file_shard=(pid, nproc))

    # global counter reduction (every process participates)
    local = _read_counts_csv(os.path.join(
        config.out, f'{part_name}.filter_counts_summary.csv'))
    global_counts = _allreduce_counts(local)
    multihost_utils.sync_global_devices('fslr-stages-done')
    if pid != 0:
        return

    # ---- process 0: merge per-process artifacts, then cluster ---------
    base = os.path.join(config.out, config.name)
    beds = [os.path.join(config.out, f'{config.name}__p{i}.mappings.bed')
            for i in range(nproc)]
    df = Table.concat([read_tsv(p) for p in beds])
    # ties in the final keys only occur within one read, and a read lives
    # in exactly one process, so a stable re-sort reproduces the
    # single-process order exactly
    df = df.sort(['n_alignments', 'qname', 'qstart'], [False, True, True])
    mapping_table.write_mappings_bed(df, f'{base}.mappings.bed')

    _merge_bams_streamed(
        [os.path.join(config.out, f'{config.name}__p{i}.bwa_dodi.bam')
         for i in range(nproc)], f'{base}.bwa_dodi.bam')

    with open(f'{base}.without_primers.fq', 'w') as out:
        for i in range(nproc):
            p = os.path.join(config.out,
                             f'{config.name}__p{i}.without_primers.fq')
            if os.path.exists(p):
                with open(p) as fh:
                    out.write(fh.read())

    with open(f'{base}.filter_counts_summary.csv', 'w') as fc:
        cols = dict(name=config.name, **{k: v for k, v in
                                         global_counts.items()})
        fc.write('Filter counts:' + '\n')
        fc.write(','.join(str(k) for k in cols.keys()) + '\n')
        fc.write(','.join(str(v) for v in cols.values()) + '\n')

    if not config.keep_temp:
        for i in range(nproc):
            for p in glob.glob(os.path.join(
                    config.out, f'{config.name}__p{i}.*')):
                os.remove(p)

    if not config.skip_clustering:
        final_cfg = config.replace(skip_alignment=True, n_processes=1,
                                   process_id=0)
        _run_pipeline(final_cfg, backend)


def _encode_chunk_fallback(aln, qnames, seqs, fa, off, config, bam_items):
    """Per-record BAM encoding (byte-identical to the columnar fast
    path): used when exact CIGAR streams are absent for some alignment
    (emit-buffer overflow rows) or exact_cigars is off."""
    from fslr_tpu.encode import revcomp_str
    quals = fa.qual_strs(off, off + len(qnames))
    cigars = aln.cigar_lists() if config.exact_cigars else None
    for i in range(len(aln)):
        ridx = int(aln.read_idx[i])
        pri = bool(aln.is_primary[i])
        rev = bool(aln.strand_rev[i])
        flag = (16 if rev else 0) | (0 if pri else 2048)
        rspan = int(aln.rend[i]) - int(aln.rstart[i]) + 1
        core = cigars[i] if cigars is not None else None
        if core is not None:
            clip = 'S' if pri else 'H'
            cig = []
            if int(aln.qstart_o[i]) > 0:
                cig.append((int(aln.qstart_o[i]), clip))
            cig += core
            tail = int(aln.qlen[i]) - int(aln.qend_o[i])
            if tail > 0:
                cig.append((tail, clip))
        else:
            cig = bamio.approx_cigar(int(aln.qstart_o[i]),
                                     int(aln.qend_o[i]),
                                     int(aln.qlen[i]), rspan,
                                     hard_clips=not pri)
        seq = ''
        qual = None
        if pri:
            seq = seqs[ridx]
            qual = quals[ridx]
            if rev:
                seq = revcomp_str(seq)
                qual = qual[::-1] if qual else None
        bam_items.append(bamio.encode_item(bamio.BamRecord(
            qname=qnames[ridx], flag=flag,
            ref_id=int(aln.chrom_idx[i]),
            pos=int(aln.rstart[i]),
            mapq=int(aln.mapq[i]), cigar=cig, seq=seq,
            qual=qual, tags={'AS': int(aln.score[i])})))


def _run_pipeline(config: PipelineConfig, backend: str | None = None,
                  file_shard: tuple[int, int] | None = None):
    basename = os.path.join(config.out, config.name)
    print('Basename: ', basename, file=sys.stderr)
    timer = StageTimer()
    timer.start_profile()

    filter_counts = {
        'name': config.name, 'total_kept': 0, 'total_dropped': 0,
        'concatemers_dropped': 0, 'junk_seqs_dropped': 0,
        'short_seqs_dropped': 0, 'False_False': 0,
    }
    panel = load_panel().subset(config.primers)

    os.makedirs(config.out, exist_ok=True)

    if not config.skip_alignment:
        masked_ref_path = f'{basename}_temp_ref.fa'
        mask_thread = None
        if config.reference_mask:
            mask_thread = threading.Thread(
                target=refmod.write_masked_reference,
                args=(config.reference_mask, masked_ref_path, config.ref))
            mask_thread.start()

        # Load the seed index and start its device upload in the
        # background: the ~tens-of-MB genome/index transfer otherwise
        # lands inside the align stage's first fetch (the reference
        # overlaps its masked-ref build with filtering the same way,
        # main.py:78-82).
        idx_box: dict = {}

        def _load_and_upload():
            r, s = _load_indexed(config.ref, config.align.seed_k)
            try:
                if s.shards:
                    for sh in s.shards:
                        align_stage._device_arrays(sh.ref, sh.sidx)
                else:
                    align_stage._device_arrays(r, s)
            except Exception as e:
                # prefetch only — align re-issues the upload; still log it
                print(f'WARNING: device index prefetch failed '
                      f'({type(e).__name__}: {e}); align will re-upload',
                      file=sys.stderr)
            idx_box['ref'], idx_box['sidx'] = r, s

        idx_thread = threading.Thread(target=_load_and_upload, daemon=True)
        idx_thread.start()

        print('Filtering reads: ', config.basecalled, file=sys.stderr)
        fs = glob_input_files(config.basecalled)
        if file_shard is not None:
            pid_, nproc_ = file_shard
            fs = fs[pid_::nproc_]
            print(f'process {pid_}/{nproc_}: {len(fs)} input files',
                  file=sys.stderr)
        print('Input files:', fs, file=sys.stderr)
        for pth in fs:
            if os.path.getsize(pth) == 0:
                raise ValueError(f"The file '{pth}' is empty.")
        # Explicit per-process job lists, never shared-directory globs:
        # in multi-process mode every process points at the same out dir,
        # and find_primers.run_file deletes its input, so a glob here
        # could claim (and destroy) a slower sibling's intermediate.
        # The reference isolates workers the same way — uuid filenames
        # plus explicit per-worker job lists (filter_junk_from_fq.py:213-216,
        # main.py:95-114).
        handoff: dict[str, list] = {}
        filtered_files: list[str] = []
        n_workers = max(1, int(config.procs or 1))
        if n_workers > 1 and len(fs) > 1:
            # --procs honored as a host THREAD pool over input files
            # (the reference's Pool.map fan-out, main.py:95-114): device
            # kernels from concurrent files interleave on the chip while
            # each file's parse/write host work runs on its own core.
            # Results merge in input order, so counters and artifact
            # sets are identical to the serial path.
            from concurrent.futures import ThreadPoolExecutor
            with timer.stage('filter_junk'):
                with ThreadPoolExecutor(min(n_workers, len(fs))) as ex:
                    def _filter_one(pth):
                        box: dict = {}
                        c = filter_junk.run_file(pth, panel, config,
                                                 backend, out_box=box)
                        return c, box
                    results = list(ex.map(_filter_one, fs))
            for c, box in results:
                if 'path' in box:
                    handoff[box['path']] = box['reads']
                    filtered_files.append(box['path'])
                _merge_existing(filter_counts, c)
        else:
            for pth in fs:
                with timer.stage('filter_junk'):
                    box: dict = {}
                    c = filter_junk.run_file(pth, panel, config, backend,
                                             out_box=box)
                if 'path' in box:
                    handoff[box['path']] = box['reads']
                    filtered_files.append(box['path'])
                _merge_existing(filter_counts, c)

        no_primer_files: list[str] = []
        for pth in filtered_files:
            if os.path.getsize(pth) == 0:
                print(f"WARNING: The file '{pth}' is empty.",
                      file=sys.stderr)
        if n_workers > 1 and len(filtered_files) > 1:
            from concurrent.futures import ThreadPoolExecutor
            with timer.stage('find_primers'):
                with ThreadPoolExecutor(min(n_workers,
                                            len(filtered_files))) as ex:
                    cs = list(ex.map(
                        lambda p: find_primers.run_file(
                            p, panel, config, backend,
                            records=handoff.get(p)), filtered_files))
            for pth, c in zip(filtered_files, cs):
                no_primer_files.append(
                    pth.replace('.filtered_junk.fq', '.no_primers.fq'))
                _merge_all(filter_counts, c)
        else:
            for pth in filtered_files:
                with timer.stage('find_primers'):
                    c = find_primers.run_file(pth, panel, config, backend,
                                              records=handoff.get(pth))
                no_primer_files.append(
                    pth.replace('.filtered_junk.fq', '.no_primers.fq'))
                _merge_all(filter_counts, c)

        print('Filter counts: ', filter_counts, file=sys.stderr)

        # concatenate no-primer reads (main.py:118-119)
        with open(f'{basename}.without_primers.fq', 'w') as out:
            for pth in sorted(no_primer_files):
                with open(pth) as fh:
                    out.write(fh.read())
                os.remove(pth)

        # ---- alignment + selection ------------------------------------
        with timer.stage('load_index'):
            idx_thread.join()
            ref, sidx = idx_box['ref'], idx_box['sidx']
        masked = None
        if config.reference_mask:
            mask_thread.join()
            print(f'Mapping against masked reference defined by '
                  f'{config.reference_mask}', file=sys.stderr)
            masked = _load_indexed(masked_ref_path, config.align.seed_k)

        # ---- streamed align loop: chunks of align_stream_reads ---------
        # Per chunk: align -> encode BAM items (compact bytes) -> chunk
        # mapping-table frame.  Peak host memory is bounded by the chunk;
        # the final coordinate key-sort and the final bed sort are stable,
        # so artifacts are byte-identical to an unchunked run.
        # Explicit list again (not a glob): find_primers.run_file always
        # writes one .primers_labelled.fq per filtered input.
        labelled = sorted(
            pth.replace('.filtered_junk.fq', '.primers_labelled.fq')
            for pth in filtered_files)
        CH = config.batch.align_stream_reads
        bam_items: list = []
        dfs: list = []
        from fslr_tpu.encode import revcomp_str

        # Host post-processing (BAM record encode + chunk mapping-table
        # frame) of chunk k runs on ONE worker thread while the device
        # aligns chunk k+1 — the align stage spends most of its wall
        # blocked on device fetches, leaving the CPU idle (reference
        # analog: the Pool overlap of main.py:95-114; round-4 verdict
        # item 3).  Results drain in order, bounding retained chunks.
        import time as _time
        from concurrent.futures import ThreadPoolExecutor

        def _post_chunk(aln, qnames, seqs, fa, off):
            t0 = _time.perf_counter()
            items: list = []
            rle = aln.cig_rle if config.exact_cigars else None
            if rle is not None and len(aln) and bool(np.all(rle[0])):
                # columnar fast path: one vectorized payload buffer per
                # chunk (the per-record Python loop was ~80 s of the
                # 1M-read run)
                buf, ofs, plens, rids, poss, rends = \
                    bamio.encode_chunk_items(
                        aln, off, fa._names, fa.name_off, fa.codes,
                        fa.seq_off, fa._quals, fa.qual_off)
                mv = memoryview(buf)
                items.extend(
                    (r, p, e, mv[o:o + ln])
                    for r, p, e, o, ln in zip(
                        rids.tolist(), poss.tolist(), rends.tolist(),
                        ofs.tolist(), plens.tolist()))
            else:
                _encode_chunk_fallback(aln, qnames, seqs, fa, off,
                                       config, items)
            t1 = _time.perf_counter()
            df = mapping_table.mapping_table(
                aln, qnames, seqs, ref.names, config.regions, panel.seqs)
            t2 = _time.perf_counter()
            return items, df, t1 - t0, t2 - t1

        def _drain(fut):
            items, df, t_rec, t_map = fut.result()
            bam_items.extend(items)
            dfs.append(df)
            # worker wall time recorded under the historical stage names
            # (overlapped with align, so stage sums can exceed wall)
            timer.timings['bam_records'] = timer.timings.get(
                'bam_records', 0.0) + t_rec
            timer.counts['bam_records'] = timer.counts.get(
                'bam_records', 0) + 1
            timer.timings['mapping_table'] = timer.timings.get(
                'mapping_table', 0.0) + t_map
            timer.counts['mapping_table'] = timer.counts.get(
                'mapping_table', 0) + 1

        post_pool = ThreadPoolExecutor(1)
        pending: list = []
        for pth in labelled:
            with timer.stage('read_labelled'):
                fa = read_reads(pth)
            for off in range(0, fa.n, CH):
                hi = min(off + CH, fa.n)
                with timer.stage('read_labelled'):
                    qnames = fa.name_strs(off, hi)
                    seqs = fa.seq_strs(off, hi)
                with timer.stage('align'):
                    aln = align_stage.align_batch(
                        seqs, ref, sidx, config,
                        regions_path=config.regions, backend=backend,
                        masked=masked, codes=fa.codes_slice(off, hi))
                # BAM records (replaces bwa|dodi|samtools); exact CIGARs
                # come from the extension traceback walk
                pending.append(post_pool.submit(
                    _post_chunk, aln, qnames, seqs, fa, off))
                while len(pending) > 2:
                    _drain(pending.pop(0))
        while pending:
            _drain(pending.pop(0))
        post_pool.shutdown()

        with timer.stage('bam_write'):
            bamio.write_bam_items(f'{basename}.bwa_dodi.bam', ref.names,
                                  ref.lengths, bam_items, write_index=True)
        del bam_items

        if not config.keep_temp:
            for pth in glob.glob(f'{basename}_temp_ref.fa*'):
                os.remove(pth)
            for pth in labelled:
                os.remove(pth)

        assert len(glob.glob(f'{basename}.bwa_dodi.bam')) == 1

        with timer.stage('mapping_table'):
            if len(dfs) == 1:
                df = dfs[0]
            elif dfs:
                # ties in the final keys only occur within one read, and a
                # read lives in exactly one chunk, so a stable re-sort of
                # the concatenation reproduces the unchunked order exactly
                df = Table.concat(dfs).sort(
                    ['n_alignments', 'qname', 'qstart'], [False, True, True])
            else:
                df = mapping_table.mapping_table(
                    align_stage.Alignments(
                        *[np.zeros(0, np.int64)] * 12),
                    [], [], ref.names, config.regions, panel.seqs)
            mapping_table.write_mappings_bed(df,
                                             f'{basename}.mappings.bed')

        with open(f'{basename}.filter_counts_summary.csv', 'w') as fc:
            fc.write('Filter counts:' + '\n')
            fc.write(','.join(str(k) for k in filter_counts.keys()) + '\n')
            fc.write(','.join(str(v) for v in filter_counts.values()) + '\n')

        # release align-stage device residents (genome, k-mer index,
        # packed seed table — 300+ MB) before the clustering build: the
        # sharded encounter build sizes itself against HBM and the
        # 1M-read run OOM'd with these still held
        sidxs = [sidx] + ([masked[1]] if masked is not None else [])
        for s in sidxs:
            for sh in (s.shards or []):
                sh.sidx._dev = (None, None)
                sh.sidx._dev_tab = (None, None, -1)
            s._dev = (None, None)
            s._dev_tab = (None, None, -1)
        import gc
        gc.collect()

    if not config.skip_clustering:
        print('Making clusters')
        with timer.stage('read_mappings'):
            bed_file = read_tsv(f'{basename}.mappings.bed')
            chr_lengths = bamio.get_chromosome_lengths(
                f'{basename}.bwa_dodi.bam')
        with timer.stage('clustering'):
            res = cluster_stage.cluster_stage(bed_file, chr_lengths,
                                              config.cluster)
        if res.no_clusters:
            print('No clusters were found.')
            return
        with timer.stage('write_cluster_beds'):
            write_tsv(res.cluster_bed, f'{basename}.mappings.cluster.bed')
            write_tsv(res.representative_bed,
                      f'{basename}.mappings.representative.bed')

        if config.run_consensus:
            print('Creating consensus sequences')
            from fslr_tpu.stages import consensus as consensus_stage
            with timer.stage('load_index'):
                ref, sidx = _load_indexed(config.ref, config.align.seed_k)
            with timer.stage('consensus'):
                consensus_stage.run_consensus_stage(
                    res.subgraphs, bed_file, ref, sidx, panel, config,
                    backend)

    timer.stop_profile()
    timer.report(f'{basename}.timings.json')
    print('fslr finished')
