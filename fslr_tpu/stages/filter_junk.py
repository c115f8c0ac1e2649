"""Stage A: junk / concatemer filtering.

Replicates the observable contract of the reference worker
(/root/reference/fslr/filter_junk_from_fq.py:207-231 `func` +
:120-183 `get_seqs_to_drop`):

  input FASTQ/FASTA -> repeat-masked records; reads dropped as
    * junk      — any masked block > 150 bp that is non-telomeric
                  (telmer_pct <= 0.3) and repetitive (rep >= 0.3),
    * short     — len <= 200 (min length 200 plus the empty-interior case),
    * concatemer— any primer sequence (fwd or revcomp) aligns with SW score
                  >= 28 inside the read interior (100 bp end-trim), scanned
                  in 10 kb chunks with primer-length+10 overlap;
  survivors written to ``{out}/{name}.{uuid}.filtered_junk.fq`` as
  repeat-masked FASTA records (the reference writes tantan's FASTA records,
  so qualities are dropped and repeats are lowercase), with counters
  total_kept / total_dropped / junk_seqs_dropped / short_seqs_dropped /
  concatemers_dropped.

Device mapping: the tantan subprocess + per-read Python scanning becomes
batched device ops — ops/tantan.repeat_mask, ops/kmer_stats.junk_blocks and
ops/ssw.sw_max_packed over a flattened (read, window) batch with all
primers (fwd + revcomp) lane-packed into each query row.
Unlike the reference, the concatemer scan uses one window grid with a
common overlap of max(primer len)+10; any alignment scoring >= 28 spans
fewer target bases than the overlap, so decisions are identical.
"""

from __future__ import annotations

import os
import uuid
from collections import Counter

import numpy as np

from fslr_tpu import instrument
from fslr_tpu.config import PipelineConfig
from fslr_tpu.encode import bucket_length, encode, revcomp
from fslr_tpu.io.fastq import read_reads, records_to_arrays
from fslr_tpu.ops import kmer_stats, ssw, tantan
from fslr_tpu.panel import PrimerPanel
from fslr_tpu.parallel import dispatch


def _batch_from_codes(code_slices, L: int):
    """Padded (B, L) uint8 batch + lengths from encoded code slices — the
    columnar replacement for encode-from-string batching."""
    batch = np.full((len(code_slices), L), 4, dtype=np.uint8)
    lens = np.zeros(len(code_slices), dtype=np.int32)
    for i, c in enumerate(code_slices):
        c = c[:L]
        batch[i, :len(c)] = c
        lens[i] = len(c)
    return batch, lens


def _batch_rows(reads, part, step: int, L: int):
    """Padded (step, L) uint8 batch + lengths for read indices ``part``.

    Rows are CONTIGUOUS slices of the columnar codes, so per-row memcpy
    assignments beat a 2-D fancy gather ~10x (the (rows, L) int64 index
    matrix alone is 8*rows*L bytes; numpy's bounds-checked gather runs
    ~50 MB/s vs memcpy's GB/s)."""
    part_arr = np.asarray(part, np.int64)
    nb = len(part_arr)
    off = reads.seq_off
    cat = reads.codes
    batch = np.full((step, L), 4, dtype=np.uint8)
    lens = np.zeros(step, dtype=np.int32)
    if nb:
        lw = np.minimum(off[part_arr + 1] - off[part_arr], L).astype(np.int64)
        lens[:nb] = lw
        starts = off[part_arr].tolist()
        lw_l = lw.tolist()
        for r in range(nb):
            s = starts[r]
            batch[r, :lw_l[r]] = cat[s:s + lw_l[r]]
    return batch, lens


def _concatemer_windows(length: int, cfg, overlap: int):
    """Window (start, end) pairs in interior coordinates, replicating the
    reference chunk walk (filter_junk_from_fq.py:79-99)."""
    interior = length - 2 * cfg.end_trim
    if interior <= 0:
        return []
    if interior <= cfg.chunk_size:
        return [(0, interior)]
    out = []
    start = 0
    while start < interior:
        s = max(0, start - overlap)
        e = min(start + cfg.chunk_size + overlap, interior)
        out.append((s, e))
        if start + cfg.chunk_size >= interior:
            break
        start += cfg.chunk_size
    return out


def _pack_mask_device(m):
    """Bit-pack a (N, L) bool mask to (N, ceil(L/8)) uint8 on device
    (little-endian bit order, matching np.unpackbits(bitorder='little'))."""
    import jax.numpy as jnp
    N, L = m.shape
    L8 = (L + 7) // 8 * 8
    if L8 != L:
        m = jnp.pad(m, ((0, 0), (0, L8 - L)))
    w = jnp.array([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    return jnp.sum(m.reshape(N, L8 // 8, 8).astype(jnp.uint8)
                   * w[None, None, :], axis=2).astype(jnp.uint8)


def _mask_gate_packed(seq, lens, cfg):
    """Repeat mask (bit-packed) + junk gate for one batch — one fused
    device program so the multi-chip dispatch shards a single call."""
    m = tantan.repeat_mask(seq, lens, cfg)
    g = kmer_stats.junk_gates(seq, lens, m, cfg)
    return _pack_mask_device(m), g


def filter_junk_records(reads, panel: PrimerPanel,
                        config: PipelineConfig, backend: str | None = None):
    """Classify reads (a FastxArrays, or a list of FastxRecord which is
    columnarized first).  Returns (keep_flags, flat_mask, junk, short,
    concat, counters); ``flat_mask`` is a uint8 repeat mask aligned with
    ``reads.codes`` (1 = masked), the columnar analog of tantan's
    lowercase marking — per-read Python mask lists cost ~1 s/10k reads."""
    if isinstance(reads, list):
        reads = records_to_arrays(reads)
    cfg = config.junk
    counters = Counter(total_kept=0, total_dropped=0, junk_seqs_dropped=0,
                       short_seqs_dropped=0, concatemers_dropped=0)
    n = reads.n
    rlens = reads.lengths()
    keep = np.ones(n, dtype=bool)
    junk = np.zeros(n, dtype=bool)
    flat_mask = np.zeros(len(reads.codes), np.uint8)
    soff = reads.seq_off

    # ---- repeat masking + block scoring, bucketed by length ------------
    buckets: dict[int, list[int]] = {}
    for i in range(n):
        L = bucket_length(int(rlens[i]), config.batch.length_buckets)
        buckets.setdefault(L, []).append(i)

    # Dispatch every batch, then fetch ALL results in two transfers (masks
    # bit-packed 8x on device) — no per-batch blocking fetch.
    # Pass 1 computes only the repeat mask + the cheap junk GATE (block
    # length + telomere content: no sorts).  The expensive segmented-sort
    # rep score (kmer_stats.junk_blocks) runs in pass 2 on gated reads
    # only — junk requires the gate, so ungated reads are junk=False.
    import jax.numpy as jnp
    mask_pending = []       # (part, L, packed-mask dev, gate dev)
    for L, idxs in sorted(buckets.items()):
        # cap device batch so the HMM forward storage stays bounded
        step = max(1, min(config.batch.batch_size, (1 << 21) // L))
        for off in range(0, len(idxs), step):
            part = idxs[off:off + step]
            # fixed batch shape (step rows) so the HMM compiles once
            seq, lens = _batch_rows(reads, part, step, L)
            mp, g = dispatch.dp_call(_mask_gate_packed, (seq, lens),
                                     statics=(cfg,))
            # tantan HMM forward-backward: ~2 x P=100 period states per
            # base (ops/tantan.py)
            instrument.add_cells(2 * 100 * int(seq.shape[0])
                                 * int(seq.shape[1]), 'hmm')
            mask_pending.append((part, L, mp, g))
    gate = np.zeros(n, dtype=bool)
    if mask_pending:
        flat_m = np.asarray(jnp.concatenate(
            [mp.reshape(-1) for (_, _, mp, _) in mask_pending]))
        flat_g = np.asarray(jnp.concatenate(
            [gd.reshape(-1).astype(jnp.uint8)
             for (_, _, _, gd) in mask_pending]))
        mo = go = 0
        for part, L, mp, gd in mask_pending:
            msz = int(np.prod(mp.shape))
            m = np.unpackbits(
                flat_m[mo:mo + msz].reshape(mp.shape).astype(np.uint8),
                axis=1, bitorder='little')[:, :L]
            mo += msz
            part_arr = np.asarray(part, np.int64)
            nb = len(part_arr)
            gate[part_arr] = flat_g[go:go + nb].astype(bool)
            go += gd.shape[0]
            # copy batch rows into the flat per-base mask (contiguous
            # destination slices: memcpy, not scatter)
            lw = np.minimum(rlens[part_arr], L).tolist()
            starts = soff[part_arr].tolist()
            for r in range(nb):
                s = starts[r]
                flat_mask[s:s + lw[r]] = m[r, :lw[r]]

    # ---- pass 2: rep score for gated reads only -------------------------
    gated = np.flatnonzero(gate)
    if gated.size:
        gbuckets: dict[int, list[int]] = {}
        for i in gated:
            L = bucket_length(int(rlens[i]), config.batch.length_buckets)
            gbuckets.setdefault(L, []).append(int(i))
        rep_pending = []    # (part, junk dev)
        for L, idxs in sorted(gbuckets.items()):
            cap = max(1, min(config.batch.batch_size, (1 << 21) // L))
            for off in range(0, len(idxs), cap):
                part = idxs[off:off + cap]
                # pow2-padded row count: bounded compiled-shape set
                step = 8
                while step < len(part):
                    step *= 2
                step = min(step, cap)
                seq, lens = _batch_rows(reads, part, step, L)
                m = np.zeros((step, L), dtype=bool)
                part_arr = np.asarray(part, np.int64)
                lw = np.minimum(rlens[part_arr], L).tolist()
                starts = soff[part_arr].tolist()
                for r in range(len(part_arr)):
                    s = starts[r]
                    m[r, :lw[r]] = flat_mask[s:s + lw[r]]
                j = dispatch.dp_call(kmer_stats.junk_blocks,
                                     (seq, lens, jnp.asarray(m)),
                                     statics=(cfg,))
                rep_pending.append((part, j))
        flat_j = np.asarray(jnp.concatenate(
            [jd.reshape(-1).astype(jnp.uint8) for (_, jd) in rep_pending])
            if len(rep_pending) > 1
            else rep_pending[0][1].astype(jnp.uint8))
        jo = 0
        for part, jd in rep_pending:
            for bi, i in enumerate(part):
                junk[i] = bool(flat_j[jo + bi])
            jo += jd.shape[0]

    # ---- short / concatemer for non-junk reads -------------------------
    # All primers (fwd + revcomp) lane-pack into query rows at a fixed
    # stride (ops/ssw.sw_max_packed) so one row scans one window against
    # 128//stride primers at once — the drop test is "any primer >= 28",
    # exactly the packed row maximum.
    primers = [panel.seqs[k] for k in panel.names]
    prim_codes = ([encode(p) for p in primers]
                  + [revcomp(encode(p)) for p in primers])
    maxp = max((len(p) for p in primers), default=0)
    overlap = maxp + cfg.chunk_overlap_pad
    stride = 32
    while stride < maxp:
        stride *= 2
    if prim_codes:
        qrows, _, _ = ssw.pack_queries(prim_codes, stride)
    else:
        qrows = np.zeros((0, 128), np.uint8)
    n_qrows = len(qrows)

    # window rows (read_idx, window_start, window_end, qrow_idx), built
    # vectorized: almost every read fits one window (interior <=
    # chunk_size); only long reads take the reference chunk walk
    interior = rlens.astype(np.int64) - 2 * cfg.end_trim
    short = ~junk & ((rlens < cfg.min_read_length) | (interior <= 0))
    cand = np.flatnonzero(~junk & ~short)
    simple = cand[interior[cand] <= cfg.chunk_size]
    multi = cand[interior[cand] > cfg.chunk_size]
    qi_tile = np.tile(np.arange(n_qrows, dtype=np.int64), len(simple))
    wr_i = [np.repeat(simple, n_qrows)]
    wr_s = [np.zeros(len(simple) * n_qrows, np.int64)]
    wr_e = [np.repeat(interior[simple], n_qrows)]
    wr_q = [qi_tile]
    for i in multi:
        for (s, e) in _concatemer_windows(int(rlens[i]), cfg, overlap):
            wr_i.append(np.full(n_qrows, i, np.int64))
            wr_s.append(np.full(n_qrows, s, np.int64))
            wr_e.append(np.full(n_qrows, e, np.int64))
            wr_q.append(np.arange(n_qrows, dtype=np.int64))
    wr_i = np.concatenate(wr_i)
    wr_s = np.concatenate(wr_s)
    wr_e = np.concatenate(wr_e)
    wr_q = np.concatenate(wr_q)

    concat = np.zeros(n, dtype=bool)
    if len(wr_i):
        wlen = int(np.max(wr_e - wr_s))
        WT = bucket_length(wlen, (512, 1024, 1536, 2048, 3072, 4096,
                                  6144, 8192,
                                  cfg.chunk_size + 2 * overlap + 64))
        CHUNK = 8192     # fixed-shape chunks: stable compiled shapes
        pending = []
        cat_all = reads.codes
        for off in range(0, len(wr_i), CHUNK):
            sl = slice(off, min(off + CHUNK, len(wr_i)))
            # interior window [end_trim+s, end_trim+e) of each read
            # (clipped to the read's interior end); windows are
            # contiguous code slices — per-row memcpy, not a 2-D gather
            we = np.minimum(wr_e[sl],
                            rlens[wr_i[sl]] - 2 * cfg.end_trim)
            wl = np.maximum(we - wr_s[sl], 0)
            start = soff[wr_i[sl]] + cfg.end_trim + wr_s[sl]
            nw = len(wl)
            t = np.full((nw, WT), 4, dtype=np.uint8)
            st_l, wl_l = start.tolist(), wl.tolist()
            for r in range(nw):
                s = st_l[r]
                t[r, :wl_l[r]] = cat_all[s:s + wl_l[r]]
            tlens = wl.astype(np.int32)
            q = qrows[wr_q[sl]]
            score, _, _ = dispatch.dp_call(
                ssw.sw_max_packed, (q, t, tlens),
                statics=(config.scoring, stride, backend))
            instrument.add_cells(int(tlens.sum(dtype=np.int64)) * 128,
                                 'sw_concat')
            pending.append(score)
        flat_s = np.asarray(jnp.concatenate(
            [jnp.ravel(s) for s in pending]) if len(pending) > 1
            else jnp.ravel(pending[0]))
        concat[wr_i[flat_s >= cfg.concatemer_score]] = True

    # ---- decisions + counters (reference order: junk, then short/concat).
    # Totals go through dispatch.dp_sum: plain numpy sums single-device,
    # per-shard partial sums + psum over the mesh (the reference's
    # Manager-dict counters, main.py:50-57, without locks).
    keep = ~(junk | short | concat)
    nj, ns, nc, nk = dispatch.dp_sum(
        junk, ~junk & short, ~junk & ~short & concat, keep)
    counters['junk_seqs_dropped'] = nj
    counters['short_seqs_dropped'] = ns
    counters['concatemers_dropped'] = nc
    counters['total_kept'] = nk
    counters['total_dropped'] = n - nk
    return keep, flat_mask, junk, short, concat, counters


def run_file(path: str, panel: PrimerPanel, config: PipelineConfig,
             backend: str | None = None, out_box: dict | None = None) -> dict:
    """Process one input file; returns counters.  Writes
    ``{out}/{name}.{uuid}.filtered_junk.fq`` (+ ``.junk.fq`` if keep_temp),
    mirroring the reference worker's file contract
    (filter_junk_from_fq.py:213-216).  When ``out_box`` is given it
    receives {'path': out_path, 'reads': kept masked FastxArrays} so the
    primer stage can skip re-parsing the intermediate file (the file is
    still written — it is the resume/inspection contract)."""
    from fslr_tpu.io.native import _DECODE, FastxArrays

    reads = read_reads(path)
    keep, flat_mask, junk, short, concat, counters = filter_junk_records(
        reads, panel, config, backend)
    temp_name = str(uuid.uuid4())
    out_path = os.path.join(config.out,
                            f'{config.name}.{temp_name}.filtered_junk.fq')
    junk_path = os.path.join(config.out, f'{config.name}.{temp_name}.junk.fq')
    # the reference writes tantan's FASTA records: qualities are dropped,
    # repeats lowercase (filter_junk_from_fq.py:170-172).  Decode ALL
    # sequences in one vector pass (ASCII | 0x20 where masked); the
    # per-read loop below is pure C-level bytes slicing.
    raw = _DECODE[reads.codes]
    if flat_mask.any():
        raw = raw | (flat_mask.astype(np.uint8) << 5)
    seq_buf = raw.tobytes()
    soff = reads.seq_off.tolist()
    noff = reads.name_off.tolist()
    coff = reads.comment_off.tolist()
    names_b, comm_b = reads._names, reads._comments
    kept_idx = []
    parts: list[bytes] = []
    jparts: list[bytes] = []
    keep_l, junk_l, short_l = keep.tolist(), junk.tolist(), short.tolist()
    for i in range(reads.n):
        if keep_l[i]:
            head = names_b[noff[i]:noff[i + 1]]
            c = comm_b[coff[i]:coff[i + 1]]
            if c:
                head = head + b' ' + c
            parts.append(b'>' + head + b'\n'
                         + seq_buf[soff[i]:soff[i + 1]] + b'\n')
            kept_idx.append(i)
        elif config.keep_temp:
            suffix = (b'_junk' if junk_l[i]
                      else b'_short' if short_l[i] else b'_concatemer')
            head = names_b[noff[i]:noff[i + 1]] + suffix
            c = comm_b[coff[i]:coff[i + 1]]
            if c:
                head = head + b' ' + c
            jparts.append(b'>' + head + b'\n'
                          + seq_buf[soff[i]:soff[i + 1]] + b'\n')
    with open(out_path, 'wb') as out:
        out.write(b''.join(parts))
    if config.keep_temp:
        with open(junk_path, 'wb') as junkf:
            junkf.write(b''.join(jparts))
    if out_box is not None:
        if len(kept_idx) == reads.n:
            # all kept: reuse the columnar buffers, no copies
            kept = FastxArrays(
                reads.n, reads.codes, flat_mask.astype(np.uint8),
                reads.seq_off, reads._names, reads.name_off,
                b'', reads.qual_off, reads._comments, reads.comment_off)
        else:
            so = reads.seq_off
            kept = reads.subset(
                kept_idx,
                lower_override=[flat_mask[so[i]:so[i + 1]]
                                for i in kept_idx])
            kept._quals = b''   # the handoff mirrors the FASTA file
        out_box['path'] = out_path
        out_box['reads'] = kept
    return dict(counters)
