"""Stage B: primer identification + trimming.

Replicates the observable contract of the reference
(/root/reference/fslr/find_reads_with_primers.py):

  * all primer-pair orientation combos (F/R at each end) over the 68 bp
    ``primer_alignment_target`` sequences (:80-91);
  * per read, each pair's p1 aligned to the first min(len/2, 500) bp and p2
    to the last min(len/2, 500) bp; score normalized by 2*len(target)
    (:48-63);
  * labels are 'False' below trim_threshold (default 0.4); best pair by
    rounded score1+score2 (:59-65);
  * trim to [aln1.target_begin, len - p2_space + aln2.target_end_optimal]
    (exclusive end, reproducing the reference slice off-by-one) — applied
    even when one side is 'False' (:69-74);
  * rename ``{name}.{s1}_{s2}.{lab1}_{lab2}`` and route to
    ``.primers_labelled.fq`` / ``.no_primers.fq`` (:107-113);
  * counters: starting_bases / trimmed_bases / trimmed_reads / per-label
    combo counts (:93-114).

Device mapping: the per-pair SSW loop collapses to one batched device call per
window side — alignments depend only on (primer, orientation, window), so
we compute the |P|*2 distinct alignments per side and combine scores into
the |P|^2 * 4 pair matrix on host (identical results, 4|P|x fewer
alignments than the reference loop).

Tie-breaking note: the reference enumerates pairs from an unordered
``set`` and takes the last max under a stable sort, so its tie-break among
equal-scoring pairs is unspecified (process-dependent hash order).  We fix
a deterministic order: panel order for k1, then k2, with orientation combos
in reference append order [(F,R), (R,F), (F,F), (R,R)]; ties pick the last
pair in this order.
"""

from __future__ import annotations

import os
from collections import Counter

import numpy as np

from fslr_tpu import instrument
from fslr_tpu.config import PipelineConfig
from fslr_tpu.encode import encode, revcomp
from fslr_tpu.io.fastq import FastxRecord, read_reads, records_to_arrays
from fslr_tpu.ops import ssw
from fslr_tpu.panel import PrimerPanel
from fslr_tpu.parallel import dispatch

ORIENT_COMBOS = (('F', 'R'), ('R', 'F'), ('F', 'F'), ('R', 'R'))


_SW_KEYS = ('score', 'target_begin', 'target_end')
_SW_CHUNK = 8192


def _dispatch_side(reads, targets, window, scoring, side: str,
                   backend=None):
    """Dispatch SW of every (primer target, orientation) against one window
    side of every read, in fixed-shape chunks (a single n*m-row call
    compiled a fresh kernel per dataset size).  Returns (device chunks,
    n, m); fetch with _fetch_sides."""
    import jax.numpy as jnp
    n = reads.n
    m = len(targets)
    NW = n * m
    # windows are per READ (identical across the m targets): build each
    # once with a strided gather over the columnar codes, then repeat —
    # the per-(read x target) fill loop cost ~1 s per 10k reads
    cat = reads.codes
    off = reads.seq_off
    L = np.diff(off).astype(np.int64)
    space = np.minimum(L // 2, window)
    ar = np.arange(512, dtype=np.int64)
    start = off[:-1] if side == 'start' else off[1:] - space
    pos = start[:, None] + ar[None, :]
    wv = cat[np.minimum(pos, max(len(cat) - 1, 0))] if len(cat) else \
        np.full((n, 512), 4, np.uint8)
    win = np.where(ar[None, :] < space[:, None], wv, 4).astype(np.uint8)
    t = np.repeat(win, m, axis=0)
    tlens = np.repeat(space.astype(np.int32), m)
    qmat = np.full((m, 128), 4, dtype=np.uint8)
    qlen1 = np.zeros(m, np.int32)
    for j, tc in enumerate(targets):
        qmat[j, :len(tc)] = tc
        qlen1[j] = len(tc)
    q = np.tile(qmat, (n, 1))
    qlens = np.tile(qlen1, n)
    outs = []
    off = 0
    while off < NW:
        rows = _SW_CHUNK
        if NW - off < _SW_CHUNK:        # tail: pow2-padded row count
            rows = 8
            while rows < NW - off:
                rows *= 2
        sl = slice(off, off + rows)     # numpy slices clamp; re-pad below
        qc, tc_, qlc, tlc = q[sl], t[sl], qlens[sl], tlens[sl]
        if len(qc) < rows:
            pad = rows - len(qc)
            qc = np.pad(qc, ((0, pad), (0, 0)), constant_values=4)
            tc_ = np.pad(tc_, ((0, pad), (0, 0)), constant_values=4)
            qlc = np.pad(qlc, (0, pad))
            tlc = np.pad(tlc, (0, pad))
        res = dispatch.dp_call(ssw.sw_locate, (qc, tc_, qlc, tlc),
                               statics=(scoring, backend))
        instrument.add_cells(int((qlc.astype(np.int64) * tlc).sum()),
                             'sw_primer')
        outs.append(jnp.stack([res[k].astype(jnp.float32)
                               for k in _SW_KEYS]))
        off += rows
    return outs, n, m


def _fetch_sides(dispatched):
    """ONE device->host transfer for all dispatched side-chunks; returns a
    list of dicts of (n, m) arrays keyed by _SW_KEYS."""
    import jax.numpy as jnp
    flats = [o.reshape(-1) for (outs, _, _) in dispatched for o in outs]
    flat = np.asarray(jnp.concatenate(flats) if len(flats) > 1
                      else flats[0])
    res = []
    off = 0
    for outs, n, m in dispatched:
        cols = {k: np.zeros(n * m, np.float32) for k in _SW_KEYS}
        done = 0
        for o in outs:
            rows = int(o.shape[1])
            block = flat[off:off + 3 * rows].reshape(3, rows)
            off += 3 * rows
            take = min(rows, n * m - done)
            for ki, k in enumerate(_SW_KEYS):
                cols[k][done:done + take] = block[ki, :take]
            done += take
        res.append({k: v.reshape(n, m) for k, v in cols.items()})
    return res


_DEC_TABLE = np.frombuffer(b'ACGTN', dtype=np.uint8)


def _to_str(codes: np.ndarray, lower: np.ndarray | None) -> str:
    raw = _DEC_TABLE[codes]
    if lower is not None and len(lower) and lower.any():
        raw = raw | (lower[:len(raw)].astype(np.uint8) << 5)
    return raw.tobytes().decode('ascii')


def label_and_chop(reads, panel: PrimerPanel,
                   config: PipelineConfig, backend: str | None = None):
    """Returns (labelled_records, has_primer_flags, counters).  ``reads``
    is a columnar FastxArrays (or a list of FastxRecord, columnarized
    first); output records are materialized strings since they go straight
    to the output files."""
    if isinstance(reads, list):
        reads = records_to_arrays(reads)
    cfg = config.primer
    names = list(panel.names)
    # distinct (primer, orientation) targets, panel order, F then R per name
    tdefs = []          # (name, strand, codes)
    for k in names:
        tc = encode(panel.targets[k])
        tdefs.append((k, 'F', tc))
        tdefs.append((k, 'R', revcomp(tc)))
    tcodes = [c for (_, _, c) in tdefs]
    tlen = np.array([len(c) for c in tcodes])

    counters = Counter()
    counters['starting_bases'] = 0
    counters['trimmed_bases'] = 0
    counters['trimmed_reads'] = 0

    if reads.n == 0:
        return [], np.zeros(0, bool), counters

    d1 = _dispatch_side(reads, tcodes, cfg.search_window, config.scoring,
                        'start', backend)
    d2 = _dispatch_side(reads, tcodes, cfg.search_window, config.scoring,
                        'end', backend)
    a1, a2 = _fetch_sides([d1, d2])

    # pair enumeration (deterministic; see module docstring)
    pair_defs = []      # (t1_idx, t2_idx, k1, k2, s1, s2)
    for i1, k1 in enumerate(names):
        for i2, k2 in enumerate(names):
            for (s1, s2) in ORIENT_COMBOS:
                t1 = 2 * i1 + (0 if s1 == 'F' else 1)
                t2 = 2 * i2 + (0 if s2 == 'F' else 1)
                pair_defs.append((t1, t2, k1, k2, s1, s2))
    p1_idx = np.array([p[0] for p in pair_defs])
    p2_idx = np.array([p[1] for p in pair_defs])

    # normalized scores (float64, matching reference host arithmetic)
    max_score = (2.0 * tlen).astype(np.float64)
    s1 = a1['score'].astype(np.float64)[:, p1_idx] / max_score[p1_idx]
    s2 = a2['score'].astype(np.float64)[:, p2_idx] / max_score[p2_idx]
    sums = np.round(s1, 2) + np.round(s2, 2)
    # last max wins (stable sort + take-last in the reference)
    best = sums.shape[1] - 1 - np.argmax(sums[:, ::-1], axis=1)

    # ---- vectorized trim/label math (the per-read float conversions
    # and round() calls cost ~1 s per 10k reads) ----------------------
    nR = reads.n
    ai = np.arange(nR)
    t1 = p1_idx[best]
    t2 = p2_idx[best]
    sc1 = a1['score'].astype(np.float64)[ai, t1] / max_score[t1]
    sc2 = a2['score'].astype(np.float64)[ai, t2] / max_score[t2]
    f1 = sc1 < cfg.trim_threshold
    f2 = sc2 < cfg.trim_threshold
    L_all = np.diff(reads.seq_off).astype(np.int64)
    p2_space = np.minimum(L_all // 2, cfg.search_window)
    tb = a1['target_begin'][ai, t1].astype(np.int64)
    te = (L_all - p2_space
          + a2['target_end'][ai, t2].astype(np.int64))
    no_primer = f1 & f2
    tb_eff = np.where(no_primer, 0, tb)
    te_eff = np.where(no_primer, L_all, te)
    trimmed = tb_eff + (L_all - te_eff)
    has_primer = ~no_primer
    counters['starting_bases'] = int(L_all.sum())
    counters['trimmed_bases'] = int(trimmed.sum())
    counters['trimmed_reads'] = int((trimmed > 0).sum())
    lab1_by_pair = [k1 + st1 for (_, _, k1, _, st1, _) in pair_defs]
    lab2_by_pair = [k2 + st2 for (_, _, _, k2, _, st2) in pair_defs]
    lab1 = np.array(lab1_by_pair, object)[best]
    lab2 = np.array(lab2_by_pair, object)[best]
    lab1[f1] = 'False'
    lab2[f2] = 'False'
    r1_all = np.round(sc1, 2)
    r2_all = np.round(sc2, 2)
    combos, combo_counts = np.unique(
        np.array([f'{x}_{y}' for x, y in zip(lab1, lab2)], object),
        return_counts=True)
    for cb, ct in zip(combos, combo_counts):
        counters[str(cb)] += int(ct)

    out_records = []
    for i in range(nR):
        codes = reads.seq_codes(i)[tb_eff[i]:te_eff[i]]
        lower = reads.lower_mask(i)[tb_eff[i]:te_eff[i]]
        qual = reads.qual(i)
        if qual and not no_primer[i]:
            qual = qual[tb_eff[i]:te_eff[i]]
        new_name = (f'{reads.name(i)}.{r1_all[i]}_{r2_all[i]}.'
                    f'{lab1[i]}_{lab2[i]}')
        out_records.append(FastxRecord(name=new_name,
                                       sequence=_to_str(codes, lower),
                                       quality=qual,
                                       comment=reads.comment(i)))
    return out_records, has_primer, counters


def run_file(path: str, panel: PrimerPanel, config: PipelineConfig,
             backend: str | None = None,
             records=None) -> dict:
    """Process one ``.filtered_junk.fq`` file, writing
    ``{basename}.primers_labelled.fq`` and ``{basename}.no_primers.fq``
    (reference find_reads_with_primers.py:99-113,120-133).  ``records``
    (a FastxArrays or a record list) short-circuits re-parsing when the
    caller already holds the file's reads (filter_junk.run_file out_box
    handoff)."""
    if 'filtered_junk' in path:
        basename = path.replace('.filtered_junk.fq', '')
    else:
        basename = path.replace('.fa', '')
    if records is None:
        records = read_reads(path)
    out_records, has_primer, counters = label_and_chop(
        records, panel, config, backend)
    with open(f'{basename}.primers_labelled.fq', 'w') as out, \
         open(f'{basename}.no_primers.fq', 'w') as out2:
        for rec, hp in zip(out_records, has_primer):
            (out if hp else out2).write(str(rec) + '\n')
    if 'filtered_junk' in path and not config.keep_temp:
        os.remove(path)
    return dict(counters)
