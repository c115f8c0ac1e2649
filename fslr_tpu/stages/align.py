"""Alignment stage: seed -> band candidates -> banded extension -> selection.

The bwa mem + dodi replacement (reference call sites
/root/reference/fslr/main.py:121-171).  Per read batch:

  1. device seeding of forward and reverse-complement strands against the
     host-built k-mer index (ops/seed.py);
  2. candidate diagonal bands filtered by seed support (min_chain_seeds /
     min_band_span are this engine's analogs of bwa's chain filters);
  3. banded affine extension of each candidate (ops/banded.py), forward
     pass for (score, qend, rend) then a reversed-prefix pass for begins;
  4. per-read split-alignment selection DP (ops/selection.py) with
     optional region bias (dodi --bias/--include);
  5. primary designation = max original score among selected
     (collect_mapping_info.py:42-48 workaround semantics).

Alignment records carry query coordinates in *record orientation* (the
aligned strand's coordinates, as a SAM record's CIGAR clips would encode
them), plus the strand flag, so the mapping-table stage can replicate the
reference's strand-normalization math exactly.

MAPQ follows the bwa-mem single-end model family (score-gap scaled by
squared identity with a long-read length damping term, minus a
log-penalty for the number of comparable sub-optimal hits; clamped to
[0, 60]).  s2 (the "sub" score) is the best unselected candidate whose
forward-strand query span overlaps the selected alignment by >50%,
floored at min_seed_len * match_score exactly as bwa floors sub at
``opt->min_seed_len * opt->a``.  The reference pipeline never filters on
MAPQ (mappings.bed carries it through verbatim), so downstream parity
does not depend on the exact constants.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from fslr_tpu import instrument
from fslr_tpu.config import PipelineConfig
from fslr_tpu.encode import _COMP, bucket_length, encode, revcomp
from fslr_tpu.index.reference import Reference, SeedIndex
from fslr_tpu.index.reference import packed_seed_table \
    as refmod_packed_seed_table
from fslr_tpu.ops import banded, seed, selection
from fslr_tpu.parallel import dispatch

# ---------------------------------------------------------------------------
# Sub-phase wall-clock accounting (FSLR_ALIGN_TIMERS=1): per-phase timers
# (assembly vs dispatch vs fetch) attribute the align stage's wall time to
# host work and device round trips.  Zero overhead when disabled.

import os as _os
import time as _time

_SUBT: dict = {}
_SUBT_ON = bool(_os.environ.get('FSLR_ALIGN_TIMERS'))


class _sub:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        if _SUBT_ON:
            self.t0 = _time.perf_counter()

    def __exit__(self, *a):
        if _SUBT_ON:
            _SUBT[self.name] = (_SUBT.get(self.name, 0.0)
                                + _time.perf_counter() - self.t0)


def sub_timings(reset=True):
    out = dict(_SUBT)
    if reset:
        _SUBT.clear()
    return out


@dataclasses.dataclass
class Alignments:
    """Flat arrays over alignments (selected only unless noted)."""
    read_idx: np.ndarray      # index into the input record list
    chrom_idx: np.ndarray     # contig index into Reference.names
    rstart: np.ndarray        # 0-based inclusive, contig-local
    rend: np.ndarray          # 0-based inclusive
    strand_rev: np.ndarray    # bool, True = reverse strand
    qstart_o: np.ndarray      # record-orientation query start (0-based)
    qend_o: np.ndarray        # record-orientation query end (exclusive)
    qlen: np.ndarray          # full read length
    score: np.ndarray         # alignment score (original, unbiased)
    mapq: np.ndarray
    is_primary: np.ndarray    # bool
    overlaps_region: np.ndarray  # bool (all False when no --regions)
    cigars: list | None = None   # per-alignment core CIGAR ops (M/I/D)
    # columnar exact-CIGAR RLE (has, cnt, flat_len, flat_op), op codes
    # 0/1/2 = M/I/D — the form the vectorized BAM encoder consumes
    # (io/bam.encode_chunk_items); cigars lists are derived lazily
    cig_rle: tuple | None = None

    def __len__(self):
        return len(self.read_idx)

    def cigar_lists(self):
        """Per-alignment [(len, op_char), ...] lists (None where no emit
        stream exists), derived from cig_rle when not already present."""
        if self.cigars is not None:
            return self.cigars
        if self.cig_rle is None:
            return None
        has, cnt, flat_len, flat_op = self.cig_rle
        out = [None] * len(self)
        ends = np.cumsum(cnt)
        starts = ends - cnt
        ll = flat_len.tolist()
        oo = flat_op.tolist()
        for i in np.flatnonzero(has):
            out[i] = [(ll[t], 'MID'[oo[t]])
                      for t in range(starts[i], ends[i])]
        return out


_SLICE_BUCKETS = (256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096,
                  6144, 8192, 12288, 16384, 24576, 32768)


def _pad128(n):
    return ((n + 127) // 128) * 128


def _device_arrays(ref: Reference, sidx: SeedIndex):
    """Device-resident genome (word-packed, ops/banded.pack_codes_host) +
    index, cached on the SeedIndex so repeated batches don't re-upload
    (the genome can be ~1 GB/shard).  Under an active mesh the tables are placed
    replicated across every device up front (one transfer, not one per
    sharded kernel call)."""
    mesh = dispatch.active_mesh()
    cached_mesh, cached = getattr(sidx, '_dev', (None, None))
    if cached is None or cached_mesh is not mesh:
        with _sub('upload.tables'):
            import jax
            import jax.numpy as jnp
            arrs = (banded.pack_codes_host(ref.codes),
                    sidx.counts.astype(np.int32),
                    sidx.positions.astype(np.int32))
            if mesh is not None and mesh.devices.size > 1:
                from jax.sharding import NamedSharding, PartitionSpec as P
                sh = NamedSharding(mesh, P())
                cached = tuple(jax.device_put(a, sh) for a in arrs)
            else:
                cached = tuple(jnp.asarray(a) for a in arrs)
            sidx._dev = (mesh, cached)
    return cached


def _device_cat(cat: np.ndarray):
    """Upload the concatenated read codes once per batch, WORD-PACKED
    (ops/banded.pack_codes_host) — every kernel gathers its row slices
    from this with int32 word gathers (replicated across the mesh when
    one is active)."""
    packed = banded.pack_codes_host(cat)
    mesh = dispatch.active_mesh()
    if mesh is not None and mesh.devices.size > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.device_put(packed, NamedSharding(mesh, P()))
    return jnp.asarray(packed)


def _build_regions(regions_path, names):
    """regions bed -> per-contig sorted interval arrays (pd.Interval
    semantics in the reference are closed intervals; overlap test below
    replicates Interval.overlaps for closed endpoints)."""
    per = {}
    if not regions_path:
        return per
    name_set = set(names)
    with open(regions_path) as fh:
        for line in fh:
            f = line.strip().split('\t')
            if len(f) < 3 or f[0] not in name_set:
                continue
            per.setdefault(f[0], []).append((int(f[1]), int(f[2])))
    return {k: np.array(sorted(v)) for k, v in per.items()}


def _overlaps_region(regions, chrom_name, start, end):
    iv = regions.get(chrom_name)
    if iv is None or len(iv) == 0:
        return False
    # closed-interval overlap (pd.Interval default closed='right'; the
    # reference builds Interval(left=start, right=end) default closed
    # 'right' and t=(start+1-based, end)): overlap iff not disjoint.
    return bool(np.any((iv[:, 0] < end) & (start < iv[:, 1])))


@dataclasses.dataclass
class Cands:
    """Struct-of-arrays candidate bands, one row per (read, strand,
    diagonal band) — the dict/tuple-per-candidate representation cost
    seconds of pure Python per 10k reads (round-2 verdict)."""
    ridx: np.ndarray     # int64 read index
    srev: np.ndarray     # bool, reverse strand
    dga: np.ndarray      # int64 diagonal anchor (global ref coords)
    cnt: np.ndarray      # int64 seed count
    qmn: np.ndarray      # int64 min seed query pos (strand orientation)
    qmx: np.ndarray      # int64 max seed query pos
    wcnt: np.ndarray     # int64 occ-sampling-corrected seed weight

    def __len__(self):
        return len(self.ridx)

    def take(self, idx):
        return Cands(*(getattr(self, f.name)[idx]
                       for f in dataclasses.fields(self)))

    @staticmethod
    def concat(parts):
        parts = [p for p in parts if len(p)]
        if not parts:
            return _empty_cands()
        return Cands(*(np.concatenate([getattr(p, f.name) for p in parts])
                       for f in dataclasses.fields(Cands)))


def _empty_cands() -> Cands:
    return Cands(np.zeros(0, np.int64), np.zeros(0, bool),
                 np.zeros(0, np.int64), np.zeros(0, np.int64),
                 np.zeros(0, np.int64), np.zeros(0, np.int64),
                 np.zeros(0, np.int64))


@dataclasses.dataclass
class CandAln:
    """Struct-of-arrays candidate alignments (pre-selection).

    Coordinates come from the score-only forward+reverse extension pass
    (ops/banded.banded_extend_score) -- CIGARs are NOT computed here.  The
    ``ext_*`` columns carry everything needed to re-run the (17x slower)
    traceback-emit kernel on the dodi-selected winners only
    (_emit_selected): the window geometry in the SOURCE genome's global
    coordinates plus ``src`` indexing into ``genomes`` (one entry per
    reference: main / masked / index shard -- (device codes, host codes))."""
    read_idx: np.ndarray     # int64
    strand_rev: np.ndarray   # bool
    chrom_idx: np.ndarray    # int64
    rstart: np.ndarray       # int64 contig-local 0-based inclusive
    rend: np.ndarray         # int64
    qstart_o: np.ndarray     # int64 record-orientation
    qend_o: np.ndarray       # int64 exclusive
    qlen: np.ndarray         # int64
    score: np.ndarray        # int64
    ext_ws: np.ndarray       # int64 window start (source-global coords)
    ext_qlo: np.ndarray      # int64 query slice start (strand orientation)
    ext_qlen: np.ndarray     # int32 kernel qlens value (slice length)
    ext_sl: np.ndarray       # int32 slice bucket (kernel row width)
    ext_cmin: np.ndarray     # int64 contig lower bound (source-global)
    ext_cmax: np.ndarray     # int64 contig upper bound (source-global)
    src: np.ndarray          # int32 index into genomes
    genomes: list            # (device codes, host codes) per source

    _COLS = ('read_idx', 'strand_rev', 'chrom_idx', 'rstart', 'rend',
             'qstart_o', 'qend_o', 'qlen', 'score', 'ext_ws', 'ext_qlo',
             'ext_qlen', 'ext_sl', 'ext_cmin', 'ext_cmax', 'src')

    def __len__(self):
        return len(self.read_idx)

    def take(self, idx):
        return CandAln(*(getattr(self, c)[idx] for c in self._COLS),
                       self.genomes)

    @staticmethod
    def concat(parts):
        parts = [p for p in parts if len(p)]
        if not parts:
            return _empty_cand_aln()
        gens: list = []
        cols = {c: [] for c in CandAln._COLS}
        for p in parts:
            sb = p.src.copy()
            sb[sb >= 0] += len(gens)
            gens.extend(p.genomes)
            for c in CandAln._COLS:
                cols[c].append(sb if c == 'src' else getattr(p, c))
        return CandAln(*(np.concatenate(cols[c]) for c in CandAln._COLS),
                       gens)


def _empty_cand_aln() -> CandAln:
    dts = (np.int64, bool, np.int64, np.int64, np.int64, np.int64,
           np.int64, np.int64, np.int64, np.int64, np.int64, np.int32,
           np.int32, np.int64, np.int64, np.int32)
    return CandAln(*(np.zeros(0, dt) for dt in dts), [])


def align_batch(seqs: list[str], ref: Reference, sidx: SeedIndex,
                config: PipelineConfig, regions_path: str | None = None,
                backend: str | None = None,
                masked: tuple[Reference, SeedIndex] | None = None,
                codes: tuple[np.ndarray, np.ndarray] | None = None
                ) -> Alignments:
    """Align a list of read sequences.  Returns selected alignments only.

    ``masked``: optional (Reference, SeedIndex) of the masked reference;
    candidates from both references are pooled before selection, exactly as
    the reference pipeline's samtools-merge + single dodi pass arbitrates
    masked-vs-whole-reference candidates (main.py:121-141).  Masked contig
    names must be a subset of the main reference's names.
    """
    if codes is not None:
        # columnar fast path: the caller already holds 0-4 codes
        # (FastxArrays.codes_slice) — skip the string decode/re-encode
        cat, off = codes
    else:
        from fslr_tpu.encode import encode_cat
        cat, off = encode_cat(seqs)
    # ONE upload of the batch's read codes; every kernel (seeding,
    # extension, emit) gathers its row slices from this on device —
    # assembled slices would be ~10x the bytes of the codes themselves
    cat_j = _device_cat(cat)
    ca = _gather_candidates(cat, off, ref, sidx, config, backend, cat_j)
    if masked is not None:
        mref, msidx = masked
        name_to_idx = {n: i for i, n in enumerate(ref.names)}
        mca = _gather_candidates(cat, off, mref, msidx, config, backend,
                                 cat_j)
        remap = np.array([name_to_idx.get(n, -1) for n in mref.names],
                         np.int64)
        new_ci = remap[mca.chrom_idx]
        mca = mca.take(np.flatnonzero(new_ci >= 0))
        mca.chrom_idx = new_ci[new_ci >= 0]
        ca = CandAln.concat([ca, mca])
    return _select_and_finalize(ca, ref, config, regions_path,
                                cat, off, backend, cat_j)


def _gather_candidates(cat: np.ndarray, off: np.ndarray, ref: Reference,
                       sidx: SeedIndex, config: PipelineConfig,
                       backend: str | None = None,
                       cat_j=None) -> CandAln:
    """Seed + extend: candidate alignments against one reference.

    Sharded indexes (genomes > index.reference.MAX_UNSHARDED_BASES, e.g.
    whole human): candidates are gathered per shard with shard-local int32
    positions and contig ids remapped onto the parent reference — the
    selection DP then arbitrates across shards exactly as it does across
    the masked/whole candidate pool."""
    if cat_j is None:
        cat_j = _device_cat(cat)
    if sidx.shards:
        return _gather_candidates_sharded(cat, off, sidx, config, backend,
                                          cat_j)
    cands = _seed_rows(cat, off, ref, sidx, config, backend, cat_j)
    cands = _merge_near_diagonal(cands, config)
    cands = _chain_filter(cands, np.diff(off), config)
    return _extend_rows(cands, cat, off, ref, sidx, config, backend, cat_j)


def _gather_candidates_sharded(cat: np.ndarray, off: np.ndarray,
                               sidx: SeedIndex, config: PipelineConfig,
                               backend: str | None = None,
                               cat_j=None) -> CandAln:
    """Seed every shard, merge candidates to the same per-(read, strand)
    budget a single index would have (top max_candidates by seed count —
    per-shard seeding would otherwise grant each shard its own budget and
    emit extra low-support alignments), then extend per shard."""
    acfg = config.align
    parts = []
    sids = []
    if cat_j is None:
        cat_j = _device_cat(cat)
    for si, sh in enumerate(sidx.shards):
        c = _seed_rows(cat, off, sh.ref, sh.sidx, config, backend, cat_j)
        parts.append(c)
        sids.append(np.full(len(c), si, np.int32))
    cands = Cands.concat(parts)
    sid = (np.concatenate(sids) if sids else np.zeros(0, np.int32))
    n = len(cands)
    if n == 0:
        return _empty_cand_aln()
    # top max_candidates per (read, strand) by seed count (stable ties)
    ordr = np.lexsort((np.arange(n), -cands.wcnt, cands.srev,
                       cands.ridx))
    key = cands.ridx[ordr] * 2 + cands.srev[ordr]
    new_grp = np.ones(n, bool)
    new_grp[1:] = key[1:] != key[:-1]
    gstart = np.flatnonzero(new_grp)
    rank = np.arange(n) - np.repeat(gstart, np.diff(
        np.concatenate([gstart, [n]])))
    keep = np.zeros(n, bool)
    keep[ordr] = rank < acfg.max_candidates
    cands, sid = cands.take(np.flatnonzero(keep)), sid[keep]
    # near-diagonal merge must stay within one shard (extension windows
    # are shard-local); merging per shard keeps that invariant
    parts2, sids2 = [], []
    for si in np.unique(sid):
        rows = np.flatnonzero(sid == si)
        m = _merge_near_diagonal(cands.take(rows), config)
        parts2.append(m)
        sids2.append(np.full(len(m), si, np.int32))
    cands = Cands.concat(parts2)
    sid = (np.concatenate(sids2) if sids2 else np.zeros(0, np.int32))
    ck = _chain_filter_mask(cands, np.diff(off), config)
    cands, sid = cands.take(np.flatnonzero(ck)), sid[ck]
    out = []
    for si, sh in enumerate(sidx.shards):
        rows = np.flatnonzero(sid == si)
        if not len(rows):
            continue
        a = _extend_rows(cands.take(rows), cat, off, sh.ref, sh.sidx,
                         config, backend, cat_j)
        a.chrom_idx = a.chrom_idx + sh.contig_base
        out.append(a)
    return CandAln.concat(out)


def _merge_near_diagonal(cands: Cands, config: PipelineConfig) -> Cands:
    """Merge candidate bands of the SAME (read, strand) whose diagonals
    sit close enough that one banded extension bridges them.

    bwa extends a single chain across gaps cheaper than its z-drop
    (-d 200 in the reference invocation); with the seeding kill zone
    narrowed to the exact selection window (ops/seed.py), a read with a
    65-96 bp indel produces TWO adjacent-diagonal candidates that must
    become ONE bridged alignment to match that behavior.  Greedy
    chain-grouping over diagonal-sorted candidates (adjacent diagonal
    gap <= band_w * 1.5 ~ the z-drop gap threshold AND query spans
    adjacent/overlapping within the same bound — query-disjoint
    segments with coincidentally close diagonals stay separate); a
    group only merges when
    every member's diagonal stays within the extension band of the
    count-weighted mean anchor (<= band_w - 8, leaving slack for
    alignment wander) -- otherwise a light member would fall outside
    the merged band and be lost entirely.  Merged candidates take the
    summed count and the unioned query span; rows keep (read, strand,
    diagonal)-sorted order."""
    n = len(cands)
    if n <= 1:
        return cands
    band_w = config.align.band_width // 2
    gap_lim = band_w + band_w // 2
    dev_lim = band_w - 8
    ordr = np.lexsort((cands.dga, cands.srev, cands.ridx))
    r_s = cands.ridx[ordr]
    v_s = cands.srev[ordr]
    d_s = cands.dga[ordr]
    c_s = cands.cnt[ordr]
    w_s = cands.wcnt[ordr]
    mn_s = cands.qmn[ordr]
    mx_s = cands.qmx[ordr]
    brk = np.ones(n, bool)
    # a genuine indel continuation is query-CONTIGUOUS: a deletion has
    # ~zero query gap and an insertion's query gap equals its diagonal
    # shift (<= gap_lim) — two query-DISJOINT segments whose diagonals
    # happen to sit close (repeat-copy geometry) must NOT merge
    # (found by tests/test_repetitive_recall.py at 5 copies)
    qgap = np.maximum(mn_s[1:], mn_s[:-1]) - np.minimum(mx_s[1:],
                                                        mx_s[:-1])
    brk[1:] = ((r_s[1:] != r_s[:-1]) | (v_s[1:] != v_s[:-1])
               | (d_s[1:] - d_s[:-1] > gap_lim) | (qgap > gap_lim))
    gid = np.cumsum(brk) - 1
    ng = int(gid[-1]) + 1
    gcnt = np.bincount(gid, minlength=ng)
    if int(gcnt.max()) <= 1:
        return cands
    csum = np.bincount(gid, weights=c_s.astype(np.float64), minlength=ng)
    wsum = np.bincount(gid, weights=w_s.astype(np.float64), minlength=ng)
    dmean = (np.bincount(gid, weights=(d_s * c_s).astype(np.float64),
                         minlength=ng)
             / np.maximum(csum, 1)).astype(np.int64)
    dev_ok = np.ones(ng, bool)
    np.logical_and.at(dev_ok, gid, np.abs(d_s - dmean[gid]) <= dev_lim)
    do_merge = (gcnt > 1) & dev_ok
    if not np.any(do_merge):
        return cands
    gmn = np.full(ng, np.int64(2 ** 62))
    np.minimum.at(gmn, gid, mn_s)
    gmx = np.full(ng, -np.int64(2 ** 62))
    np.maximum.at(gmx, gid, mx_s)
    # keep all rows of non-merging groups + the first row of each
    # merging group (replaced by the merged candidate, in place)
    keep = (~do_merge[gid]) | brk
    idxs = np.flatnonzero(keep)
    g_of = gid[idxs]
    rep = brk[idxs] & do_merge[g_of]
    return Cands(
        ridx=r_s[idxs],
        srev=v_s[idxs],
        dga=np.where(rep, dmean[g_of], d_s[idxs]),
        cnt=np.where(rep, csum[g_of].astype(np.int64), c_s[idxs]),
        qmn=np.where(rep, gmn[g_of], mn_s[idxs]),
        qmx=np.where(rep, gmx[g_of], mx_s[idxs]),
        wcnt=np.where(rep, wsum[g_of].astype(np.int64), w_s[idxs]),
    )


def _chain_filter(cands: Cands, rlens: np.ndarray,
                  config: PipelineConfig) -> Cands:
    mask = _chain_filter_mask(cands, rlens, config)
    if mask is None:
        return cands
    return cands.take(np.flatnonzero(mask))


def _chain_filter_mask(cands: Cands, rlens: np.ndarray,
                       config: PipelineConfig):
    with _sub('chain'):
        return _chain_filter_mask_inner(cands, rlens, config)


def _chain_filter_mask_inner(cands: Cands, rlens: np.ndarray,
                             config: PipelineConfig):
    """bwa mem chain filtering (mem_chain_flt semantics; reference invokes
    bwa with -D 0.25, /root/reference/fslr/main.py:125): candidate bands of
    a read are visited in seed-count order; a band is dropped when its
    query span overlaps a kept band by >= mask_level * its own span and its
    seed count is below drop_ratio of that kept band's.  Spurious 2-3-seed
    bands shadowed by a real segment — 2/3 of all candidates on amplicon
    data — never reach the extension kernel, exactly as bwa never extends
    chains it drops here.  Comparison is across strands in forward-read
    query coordinates, like bwa's per-read chain list.  Returns a keep
    mask over rows (None = keep everything)."""
    acfg = config.align
    mask_level = acfg.chain_mask_level
    drop_ratio = acfg.chain_drop_ratio
    n = len(cands)
    if drop_ratio <= 0 or n == 0:
        return None
    L = rlens[cands.ridx]
    lo_a = np.where(cands.srev, L - cands.qmx, cands.qmn)
    hi_a = np.where(cands.srev, L - cands.qmn, cands.qmx)
    # shadowing compares the occ-sampling-corrected weights: raw counts
    # undercount sampled repeat segments by ~occ/C and true repeat
    # anchors lost extension to unique chains (50-copy recall)
    ordr = np.lexsort((np.arange(n), -cands.wcnt, cands.ridx))
    rs = cands.ridx[ordr]
    gb = np.ones(n, bool)
    gb[1:] = rs[1:] != rs[:-1]
    gstart_pos = np.flatnonzero(gb)
    sizes = np.diff(np.concatenate([gstart_pos, [n]]))
    rank = np.arange(n) - np.repeat(gstart_pos, sizes)
    cnt_s = cands.wcnt[ordr]
    lo_s = lo_a[ordr]
    hi_s = hi_a[ordr]
    span_s = np.maximum(hi_s - lo_s, 1)
    # rank-iterated shadow test, vectorized across ALL reads at once:
    # candidates per read are few (<= max_candidates), so iterating rank
    # pairs costs O(maxrank^2) vector ops instead of a Python loop over
    # every read (0.65 s per 10k reads)
    maxrank = int(rank.max()) + 1 if n else 0
    keep_s = np.zeros(n, bool)
    keep_s[rank == 0] = True          # first (highest-count) always kept
    gs_rep = np.repeat(gstart_pos, sizes)   # group start per sorted row
    for r in range(1, maxrank):
        cur = np.flatnonzero(rank == r)
        if not len(cur):
            break
        shadowed = np.zeros(len(cur), bool)
        for rp in range(r):
            prev = gs_rep[cur] + rp     # same-read candidate at rank rp
            ov = (np.minimum(hi_s[cur], hi_s[prev])
                  - np.maximum(lo_s[cur], lo_s[prev]))
            shadowed |= (keep_s[prev]
                         & (ov >= mask_level * span_s[cur])
                         & (cnt_s[cur] < drop_ratio * cnt_s[prev]))
        keep_s[cur] = ~shadowed
    keep = np.zeros(n, bool)
    keep[ordr] = keep_s
    return keep



_SEED_KEYS = ('valid', 'count', 'diag', 'qmin', 'qmax', 'wsum')


def _seed_pack(res, step, C):
    """(6, 2*step, C) -> batch-major (step, 6, 2, C) so dp_call can shard
    rows; the host fetch restores the historical (6, 2*step, C) layout
    (fwd rows then rc rows) so candidate enumeration order is unchanged."""
    packed = jnp.stack([res[kk].astype(jnp.int32) for kk in _SEED_KEYS])
    return packed.reshape(len(_SEED_KEYS), 2, step, C) \
        .transpose(2, 0, 1, 3)


def _seed_rows_build(cat32, starts, lf, L):
    """Device assembly of the (2*step, L) strand rows from the
    device-resident word-packed codes (fwd rows then rc rows; identical
    math to the host memcpy it replaces — rc[j] = comp(cat[s+lf-1-j]));
    int32 word gathers, not per-element uint8 gathers."""
    L4 = ((L + 3) // 4) * 4
    j = jnp.arange(L4, dtype=jnp.int32)[None, :]
    lw = jnp.minimum(lf, L)
    fv = banded.gather_stream(cat32, starts, L4)
    fwd = jnp.where(j < lw[:, None], fv, 4)
    # rc row j = comp(cat[s+lf-1-j]) = comp(reverse of stream from s+lf-L4)
    rvs = banded.gather_stream(cat32, starts + lf - L4, L4)[:, ::-1]
    rc = jnp.where(j < lw[:, None],
                   jnp.where(rvs < 4, 3 - rvs, rvs), 4)
    arr = jnp.concatenate([fwd, rc], axis=0)[:, :L].astype(jnp.uint8)
    lens2 = jnp.concatenate([lw, lw]).astype(jnp.int32)
    return arr, lens2


def _seed_kernel(starts, lf, cat, counts, positions, k, stride, occ_drop,
                 band_w, max_cand, S, C, L):
    """Counts/positions-path seeding with device row assembly."""
    step = starts.shape[0]
    arr, lens2 = _seed_rows_build(cat, starts, lf, L)
    res = seed.seed_candidates(arr, lens2, counts, positions, k=k,
                               stride=stride, occ_drop=occ_drop,
                               band_w=band_w, max_cand=max_cand, S=S, C=C)
    return _seed_pack(res, step, max_cand)


def _seed_kernel_tab(starts, lf, cat, table, k, stride, occ_drop,
                     band_w, max_cand, S, C, L):
    """Packed-seed-table seeding with device row assembly."""
    step = starts.shape[0]
    arr, lens2 = _seed_rows_build(cat, starts, lf, L)
    res = seed.seed_candidates(arr, lens2, None, None, k=k,
                               stride=stride, occ_drop=occ_drop,
                               band_w=band_w, max_cand=max_cand, S=S, C=C,
                               table=table)
    return _seed_pack(res, step, max_cand)


# Largest occurrence cap for which the packed seed table is used: HBM is
# 4^k * (1+C) * 4 B per index (~100 MB at k=11, C=5); repetitive genomes
# (C=16, sharded human: one table per shard) stay on the legacy path.
_MAX_TABLE_C = 8


def _build_table_device(counts, positions, C: int):
    """Device-side packed seed table build (semantics of
    index/reference.packed_seed_table, same integer math) instead of a
    host build + 80 MB upload per pipeline run; counts/positions are
    already device-resident for the legacy path, so building the table
    from them on device moves zero extra bytes."""
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=('C',))
    def build(counts, positions, *, C):
        occ = counts[1:] - counts[:-1]
        starts = counts[:-1]
        n = occ.shape[0]
        use = jnp.minimum(occ, C)
        step = jnp.maximum(occ // C, 1)
        phase = ((jnp.arange(n, dtype=jnp.uint32)
                  * jnp.uint32(2654435761))
                 >> jnp.uint32(20)).astype(jnp.int32) % step
        ci = jnp.arange(C, dtype=jnp.int32)[None, :]
        # exact int32-safe (ci*occ)//C: occ = q*C + r ->
        # (ci*occ)//C = ci*q + (ci*r)//C   (ci*r < C*C, never overflows)
        q_, r_ = occ[:, None] // C, occ[:, None] % C
        big = ci * q_ + (ci * r_) // C + phase[:, None]
        idx = starts[:, None] + jnp.where(occ[:, None] > C, big, ci)
        gmax = jnp.int32(max(int(positions.shape[0]) - 1, 0))
        v = jnp.take(positions, jnp.minimum(idx, gmax))
        cols = jnp.where(ci < use[:, None], v, 0)
        return jnp.concatenate([occ[:, None], cols], axis=1)

    return build(counts, positions, C=C)


def _device_table(sidx: SeedIndex, C: int, counts_j, pos_j):
    mesh = dispatch.active_mesh()
    cached_mesh, cached, cached_c = getattr(sidx, '_dev_tab',
                                            (None, None, -1))
    if cached is None or cached_mesh is not mesh or cached_c != C:
        with _sub('upload.seedtab'):
            cached = _build_table_device(counts_j, pos_j, C)
            sidx._dev_tab = (mesh, cached, C)
    return cached


@functools.partial(jax.jit, static_argnames=('SL',))
def _gather_q_impl(cat32, sf, er, srev, qlens, *, SL):
    """Build (N, SL) query-slice rows on device from the device-resident
    word-packed read codes: fwd row j = cat[sf + j]; rc row j =
    comp(cat[er - 1 - j]) (identical math to the host memcpy assembly it
    replaces).  Uploading assembled slices would be ~230 MB per 10k
    reads — ~10x the one-time cat upload; int32 word gathers need a
    quarter of the indices of per-element uint8 gathers."""
    j = jnp.arange(SL, dtype=jnp.int32)[None, :]
    fwd = banded.gather_stream(cat32, sf, SL)
    # rc row = comp(reverse of cat[er-SL .. er-1]); garbage beyond the
    # read is masked by qlens below (j < qlens => er-1-j >= read start)
    rcs = banded.gather_stream(cat32, er - SL, SL)[:, ::-1]
    rc = jnp.where(rcs < 4, 3 - rcs, rcs)
    v = jnp.where(srev[:, None], rc, fwd)
    return jnp.where(j < qlens[:, None], v, 4).astype(jnp.uint8)


def _pad_rows_1k(idx: np.ndarray) -> np.ndarray:
    """Pad an index array to the next 1024 multiple by repeating its first
    element, so extension-kernel batch shapes stay stable across stream
    chunks and runs (each novel shape costs a compile).
    Callers slice the padded rows off the fetched results."""
    n = len(idx)
    if n >= 1024:
        target = -(-n // 1024) * 1024
    elif n > 0:
        # small batches: pow2 bucket (<=2x compute waste; a fixed 1024
        # floor made tiny CPU-backend batches ~100x more work)
        target = max(8, 1 << (n - 1).bit_length())
    else:
        return idx
    if target == n:
        return idx
    return np.concatenate([idx, np.repeat(idx[:1], target - n)])


def _score_kernel(sf, er, srev, qlens, ws, cmin, cmax, cat, genome, SL,
                  scoring, backend):
    """Device q-slice gather + banded_extend_score; batch-major (N, 5)
    result for the sharded dispatch (call site transposes back)."""
    q = _gather_q_impl(cat, sf, er, srev, qlens, SL=SL)
    packed = banded.banded_extend_score(q, qlens, ws, cmin, cmax, genome,
                                        scoring, backend)
    return packed.T


def _emit_kernel(sf, er, srev, qlens, ws, cmin, cmax, cat, genome, SL,
                 scoring, backend):
    """Device q-slice gather + traceback-emit extension (selection
    winners only), batch-major for dispatch."""
    from fslr_tpu.ops import traceback as tbmod
    q = _gather_q_impl(cat, sf, er, srev, qlens, SL=SL)
    packed, emits = tbmod.banded_extend(q, qlens, ws, cmin, cmax, genome,
                                        scoring, backend)
    return packed.T, emits


def _select_kernel(qs, qe, sc, vmask, bias, ol_cost, max_overlap,
                   min_score):
    return selection.select_alignments(
        qs, qe, sc, vmask, ol_cost=ol_cost, max_overlap=max_overlap,
        bias=bias, min_score=min_score)


def _occ_cap(sidx: SeedIndex, acfg) -> int:
    """Data-adaptive per-seed occurrence cap: the seeding hit grid is
    (samples x cap), so a unique-k-mer reference (amplicon panels, small
    contigs) padding to the configured max (16) wastes 4x sort/NMS/gather
    work on empty slots.  Cap at the 99.9th percentile of the index's
    nonzero k-mer occupancy (floor 4, ceiling max_kmer_occ); repetitive
    genomes (human: mean 11-mer occ ~700) keep the full cap."""
    c = getattr(sidx, '_occ_cap', None)
    if c is None:
        occ = np.diff(sidx.counts)
        nz = occ[occ > 0]
        p = int(np.percentile(nz, 99.9)) if nz.size else 1
        c = int(min(acfg.max_kmer_occ, max(4, p)))
        sidx._occ_cap = c
    return c


def _seed_rows(cat: np.ndarray, off: np.ndarray, ref: Reference,
               sidx: SeedIndex, config: PipelineConfig,
               backend: str | None = None, cat_j=None) -> Cands:
    """Device seeding of both strands -> candidate diagonal bands.

    ``cat``/``off`` are the concatenated read codes + offsets
    (encode.encode_cat); ``cat_j`` the device-resident copy.  Batch rows
    are assembled ON DEVICE (_seed_rows_build) from per-read (start,
    length) vectors — the only per-batch upload is a few int32 per read."""
    acfg = config.align
    k = acfg.seed_k
    _, counts_j, pos_j = _device_arrays(ref, sidx)
    occ_cap = _occ_cap(sidx, acfg)
    use_tab = occ_cap <= _MAX_TABLE_C and sidx.positions.size > 0
    tab_j = (_device_table(sidx, occ_cap, counts_j, pos_j)
             if use_tab else None)
    if cat_j is None:
        cat_j = _device_cat(cat)

    n_reads = len(off) - 1
    rlens = np.diff(off)
    # ---- bucket reads by length ---------------------------------------
    buckets: dict[int, list[int]] = {}
    for i in range(n_reads):
        L = bucket_length(max(int(rlens[i]), k + 1),
                          config.batch.length_buckets)
        buckets.setdefault(L, []).append(i)

    col_r: list = []
    col_s: list = []
    col_d: list = []
    col_c: list = []
    col_mn: list = []
    col_mx: list = []
    col_w: list = []
    seed_pending = []     # (part, step, nb, device (step, 5, 2, C))
    for L, idxs in sorted(buckets.items()):
        S = max(1, (L - k) // acfg.seed_stride + 1)
        step = max(1, min(config.batch.batch_size,
                          (1 << 23) // max(S * occ_cap, 1)))
        for o in range(0, len(idxs), step):
            part = np.asarray(idxs[o:o + step], np.int64)
            nb = len(part)
            with _sub('seed.asm'):
                starts = np.zeros(step, np.int32)
                lf = np.zeros(step, np.int32)
                starts[:nb] = off[part]
                lf[:nb] = rlens[part]
            statics = (k, acfg.seed_stride, acfg.occ_drop,
                       acfg.band_width // 2,
                       acfg.max_candidates, S, occ_cap, L)
            with _sub('seed.disp'):
                if use_tab:
                    packed = dispatch.dp_call(
                        _seed_kernel_tab, (starts, lf),
                        (cat_j, tab_j), statics=statics)
                else:
                    packed = dispatch.dp_call(
                        _seed_kernel, (starts, lf),
                        (cat_j, counts_j, pos_j), statics=statics)
            # hit construction + diagonal sort + max_cand peel rounds all
            # scale with the (2 strands x batch x S x C) hit array
            instrument.add_cells(2 * nb * S * occ_cap, 'seed')
            seed_pending.append((part, step, nb, packed))

    # ONE device->host transfer for all seed batches (no per-batch
    # blocking fetch)
    import jax.numpy as jnp
    with _sub('seed.fetch'):
        flats = np.asarray(jnp.concatenate(
            [p.reshape(-1) for (_, _, _, p) in seed_pending])) \
            if seed_pending else np.zeros(0, np.int32)
    fo = 0
    _t_post = _sub('seed.post'); _t_post.__enter__()
    for part, step, nb, packed in seed_pending:
        size = int(np.prod(packed.shape))
        # restore the historical (6, 2*step, C) layout: fwd rows of this
        # part first, then rc rows (candidate enumeration order unchanged)
        C4 = packed.shape[3]
        p = flats[fo:fo + size].reshape(packed.shape) \
            .transpose(1, 2, 0, 3).reshape(len(_SEED_KEYS), 2 * step, C4)
        fo += size
        valid_a, count_a, diag_a, qmin_a, qmax_a, wsum_a = p
        # vectorized candidate filter; np.nonzero's row-major order equals
        # the reference iteration (fwd rows of this part, then rc rows)
        ridx_row = np.full(2 * step, -1, np.int64)
        ridx_row[:nb] = part
        ridx_row[step:step + nb] = part
        srev_row = np.zeros(2 * step, bool)
        srev_row[step:] = True
        ok = ((valid_a != 0) & (count_a >= acfg.min_chain_seeds)
              & (qmax_a - qmin_a >= acfg.min_band_span)
              & (ridx_row[:, None] >= 0))
        rr, cc = np.nonzero(ok)
        col_r.append(ridx_row[rr])
        col_s.append(srev_row[rr])
        col_d.append(diag_a[rr, cc].astype(np.int64))
        col_c.append(count_a[rr, cc].astype(np.int64))
        col_mn.append(qmin_a[rr, cc].astype(np.int64))
        col_mx.append(qmax_a[rr, cc].astype(np.int64))
        col_w.append(wsum_a[rr, cc].astype(np.int64))
    _t_post.__exit__(None, None, None)
    if not col_r:
        return _empty_cands()
    return Cands(np.concatenate(col_r), np.concatenate(col_s),
                 np.concatenate(col_d), np.concatenate(col_c),
                 np.concatenate(col_mn), np.concatenate(col_mx),
                 np.concatenate(col_w))


def _extend_rows(cands: Cands, cat: np.ndarray, off: np.ndarray,
                 ref: Reference, sidx: SeedIndex, config: PipelineConfig,
                 backend: str | None = None, cat_j=None) -> CandAln:
    acfg = config.align
    genome_j, _, _ = _device_arrays(ref, sidx)
    contig_starts = ref.offsets[:-1]
    contig_ends = ref.offsets[1:]
    n = len(cands)
    if n == 0:
        return _empty_cand_aln()
    if cat_j is None:
        cat_j = _device_cat(cat)

    # ---- extension: score-only forward+reverse pass per candidate -----
    # Each candidate extends only the seed-supported query slice
    # [qmin - margin, qmax + margin) (split segments don't pay for the
    # whole read).  Scores, ends AND begins come from the two score-only
    # banded passes (ops/banded.banded_extend_score, ~50 Gcells/s) -- the
    # ~17x slower traceback-emit kernel runs later, on selection winners
    # only (_emit_selected).  All batch assembly is vectorized: query
    # windows are contiguous (or reverse-complemented) slices of the
    # concatenated read codes, filled with per-row memcpy.
    margin = acfg.extension_margin
    Lq = np.diff(off)[cands.ridx]
    qlo = np.maximum(0, cands.qmn - margin)
    qhi = np.minimum(Lq, cands.qmx + margin)
    sl_arr = np.asarray(_SLICE_BUCKETS, np.int64)
    sl_of = sl_arr[np.minimum(
        np.searchsorted(sl_arr, np.maximum(qhi - qlo, 1)),
        len(sl_arr) - 1)]
    ws_all = cands.dga + qlo - banded.BW // 2
    mid = cands.dga + (qlo + qhi) // 2
    ci_mid = np.clip(np.searchsorted(ref.offsets, mid, side='right') - 1,
                     0, len(ref.names) - 1)
    cmin_all = contig_starts[ci_mid]
    cmax_all = contig_ends[ci_mid]
    qlens_all = qhi - qlo

    # Phase A: dispatch every chunk (windows gathered on device from the
    # device-resident genome; results stay on device).  Phase B: fetch ALL
    # chunks' packed results in ONE transfer (no per-chunk blocking
    # fetch).
    pending = []      # (chunk idx array, device packed, kernel qlens)
    for SL in np.unique(sl_of):
        cidxs = np.flatnonzero(sl_of == SL)
        SL = int(SL)
        rows_per = max(128, min(8192, (1 << 28) // max(SL * 16, 1)))
        for o in range(0, len(cidxs), rows_per):
            chunk = cidxs[o:o + rows_per]
            # pad ragged tails to a 1024-row multiple by repeating row 0
            # (results sliced off in phase B): arbitrary tail sizes each
            # compile a fresh program, and at 1M reads every stream chunk
            # has one
            ci = _pad_rows_1k(chunk)
            ri = cands.ridx[ci]
            sv = cands.srev[ci]
            ql = qlo[ci]
            qlens = np.minimum(qlens_all[ci], SL).astype(np.int32)
            # fwd rows read cat[sf+j]; rc rows read the read's reverse
            # complement: rc[qlo+j] = comp(cat[er-1-j]).  Rows are
            # gathered ON DEVICE from the resident codes (_gather_q_impl)
            # -- only these int32 vectors ever cross the link.
            with _sub('ext.asm'):
                sf = (off[ri] + ql).astype(np.int32)
                er = (off[ri] + (Lq[ci] - ql)).astype(np.int32)
            with _sub('ext.disp'):
                packed_t = dispatch.dp_call(
                    _score_kernel,
                    (sf, er, sv, qlens, ws_all[ci].astype(np.int32),
                     cmin_all[ci].astype(np.int32),
                     cmax_all[ci].astype(np.int32)),
                    (cat_j, genome_j),
                    statics=(SL, acfg.scoring, backend))
            # forward + reverse pass (padded rows excluded from the tally)
            instrument.add_cells(
                2 * int(qlens[:len(chunk)].sum(dtype=np.int64))
                * banded.BW, 'extend')
            pending.append((chunk, packed_t.T, qlens[:len(chunk)]))

    import jax.numpy as jnp
    with _sub('ext.fetch'):
        all_p = np.asarray(jnp.concatenate(
            [p.reshape(-1) for (_, p, _) in pending]))
    po = 0
    parts = []
    _t_post = _sub('ext.post'); _t_post.__enter__()
    for chunk, packed, kq in pending:
        psz = int(np.prod(packed.shape))
        p_np = all_p[po:po + psz].reshape(packed.shape)[:, :len(chunk)]
        po += psz
        score, qend, lane, qstart_c, l_fin = p_np
        keep = np.flatnonzero(score > 0)
        if not len(keep):
            continue
        ck = chunk[keep]
        sc = score[keep].astype(np.int64)
        qb = qstart_c[keep].astype(np.int64)
        qe = qend[keep].astype(np.int64)
        rbegin = ws_all[ck] + qb + l_fin[keep]
        rend = ws_all[ck] + qe + lane[keep]
        ci_ref = np.clip(
            np.searchsorted(ref.offsets, rbegin, side='right') - 1,
            0, len(ref.names) - 1)
        lo_c = ref.offsets[ci_ref]
        parts.append(CandAln(
            read_idx=cands.ridx[ck],
            strand_rev=cands.srev[ck],
            chrom_idx=ci_ref.astype(np.int64),
            rstart=rbegin - lo_c,
            rend=rend - lo_c,
            qstart_o=qlo[ck] + qb,
            qend_o=qlo[ck] + qe + 1,
            qlen=Lq[ck],
            score=sc,
            ext_ws=ws_all[ck],
            ext_qlo=qlo[ck],
            ext_qlen=kq[keep].astype(np.int32),
            ext_sl=np.full(len(ck), sl_of[ck[0]], np.int32),
            ext_cmin=cmin_all[ck],
            ext_cmax=cmax_all[ck],
            src=np.zeros(len(ck), np.int32),
            genomes=[]))
    _t_post.__exit__(None, None, None)
    if not parts:
        return _empty_cand_aln()
    out_cols = {c: np.concatenate([getattr(p, c) for p in parts])
                for c in CandAln._COLS}
    return CandAln(*(out_cols[c] for c in CandAln._COLS),
                   [(genome_j, ref.codes)])


def _empty_alignments() -> Alignments:
    return Alignments(*[np.zeros(0, dt) for dt in
                        (np.int32,) * 4 + (bool,) + (np.int32,) * 4
                        + (np.int32,) + (bool, bool)])


def _select_and_finalize(ca: CandAln, ref: Reference,
                         config: PipelineConfig,
                         regions_path: str | None,
                         cat: np.ndarray | None = None,
                         off: np.ndarray | None = None,
                         backend: str | None = None,
                         cat_j=None) -> Alignments:
    acfg = config.align
    regions = _build_regions(regions_path, ref.names)
    if len(ca) == 0:
        return _empty_alignments()

    # ---- dedup identical alignments (keep first occurrence, in order) --
    _t_prep = _sub('sel.prep'); _t_prep.__enter__()
    packed = np.empty((len(ca), 7), np.int64)
    for c, col in enumerate(('read_idx', 'strand_rev', 'chrom_idx',
                             'rstart', 'rend', 'qstart_o', 'qend_o')):
        packed[:, c] = getattr(ca, col)
    _, first = np.unique(packed, axis=0, return_index=True)
    ca = ca.take(np.sort(first))
    n = len(ca)

    # ---- selection DP per read ----------------------------------------
    reads = np.unique(ca.read_idx)
    b = np.searchsorted(reads, ca.read_idx)
    B = len(reads)
    cnts = np.bincount(b, minlength=B)
    C = min(64, max(int(cnts.max()), 1))
    # candidate slot = rank within read in encounter order; ranks >= C
    # overflow and are dropped from selection (but still count as
    # sub-optimal hits for MAPQ, like before)
    ordb = np.argsort(b, kind='stable')
    gstart = np.zeros(B + 1, np.int64)
    np.cumsum(cnts, out=gstart[1:])
    within = np.arange(n) - np.repeat(gstart[:-1], cnts)
    cslot = np.empty(n, np.int64)
    cslot[ordb] = within
    val = cslot < C

    # query overlap coordinates on the FORWARD read
    fs = np.where(ca.strand_rev, ca.qlen - ca.qend_o, ca.qstart_o)
    fe = np.where(ca.strand_rev, ca.qlen - ca.qstart_o, ca.qend_o)

    # region overlap (closed intervals, pd.Interval semantics)
    ov_any = np.zeros(n, bool)
    if regions:
        name_idx = {nm: i for i, nm in enumerate(ref.names)}
        for cname, iv in regions.items():
            ci = name_idx[cname]
            m = np.flatnonzero(ca.chrom_idx == ci)
            if not len(m):
                continue
            s_ = ca.rstart[m] + 1
            e_ = ca.rend[m] + 1
            acc = np.zeros(len(m), bool)
            for a0, b0 in iv:
                acc |= (a0 < e_) & (s_ < b0)
            ov_any[m] = acc

    qs = np.zeros((B, C), np.int32)
    qe = np.zeros((B, C), np.int32)
    sc = np.zeros((B, C), np.float32)
    bias = np.ones((B, C), np.float32)
    vmask = np.zeros((B, C), bool)
    bb, cc = b[val], cslot[val]
    qs[bb, cc] = fs[val]
    qe[bb, cc] = fe[val]
    sc[bb, cc] = ca.score[val]
    vmask[bb, cc] = True
    if regions:
        bias[bb, cc] = np.where(ov_any[val], np.float32(acfg.bias),
                                np.float32(1.0))

    # bias of all-ones is numerically identical to bias=None (score * 1.0
    # in float32 is exact), so the kernel signature stays fixed for the
    # sharded dispatch
    _t_prep.__exit__(None, None, None)
    with _sub('sel.call'):
        chosen = np.asarray(dispatch.dp_call(
            _select_kernel, (qs, qe, sc, vmask, bias),
            statics=(acfg.ol_cost, acfg.max_overlap,
                     acfg.min_selected_score)))
    sel_mask = np.zeros(n, bool)
    sel_mask[val] = chosen[bb, cc]
    sel_idx = np.flatnonzero(sel_mask)
    n_sel = len(sel_idx)
    if config.exact_cigars and cat is not None:
        cig_rle, coord_over = _emit_selected(ca, sel_idx, cat, off,
                                             config, backend, cat_j)
    else:
        cig_rle, coord_over = _no_emits(n_sel), None
    if coord_over is not None:
        # walk-derived begins replace the reverse-pass begins so CIGARs
        # and coordinates always describe the SAME co-optimal path
        qs_new, rs_new = coord_over
        ca.qstart_o[sel_idx] = qs_new
        ca.rstart[sel_idx] = rs_new

    out = Alignments(
        read_idx=ca.read_idx[sel_idx].astype(np.int32),
        chrom_idx=ca.chrom_idx[sel_idx].astype(np.int32),
        rstart=ca.rstart[sel_idx].astype(np.int32),
        rend=ca.rend[sel_idx].astype(np.int32),
        strand_rev=ca.strand_rev[sel_idx],
        qstart_o=ca.qstart_o[sel_idx].astype(np.int32),
        qend_o=ca.qend_o[sel_idx].astype(np.int32),
        qlen=ca.qlen[sel_idx].astype(np.int32),
        score=ca.score[sel_idx].astype(np.int32),
        mapq=np.zeros(n_sel, np.int32),
        is_primary=np.zeros(n_sel, bool),
        overlaps_region=ov_any[sel_idx],
        cig_rle=cig_rle,
    )
    _t_fin = _sub('fin.post'); _t_fin.__enter__()
    # primary = first max-score alignment per read (argmax tie semantics):
    # stable grouped sort instead of a per-read boolean mask (that scan is
    # O(reads x selected) — quadratic at 10k+ reads)
    if n_sel:
        ordr = np.lexsort((np.arange(n_sel), -out.score, out.read_idx))
        rid_s = out.read_idx[ordr]
        first_m = np.ones(n_sel, bool)
        first_m[1:] = rid_s[1:] != rid_s[:-1]
        out.is_primary[ordr[first_m]] = True
    # mapq: bwa-mem-style single-end model (see module docstring),
    # vectorized — per-selected Python scans of the read's unselected
    # candidates cost ~1 s at 10k reads
    match_a = acfg.scoring.match
    mismatch_b = abs(acfg.scoring.mismatch)   # bwa's b is a penalty (+3)
    sub_floor = acfg.seed_k * match_a
    if n_sel:
        fs_sel = fs[sel_idx].astype(np.int64)
        fe_sel = fe[sel_idx].astype(np.int64)
        span = fe_sel - fs_sel
        s2 = np.zeros(n_sel, np.int64)
        sub_n = np.zeros(n_sel, np.int64)
        uns = np.flatnonzero(~sel_mask)
        if len(uns):
            u_read = ca.read_idx[uns]
            u_fs = fs[uns]
            u_fe = fe[uns]
            u_sc = ca.score[uns]
            uo = np.argsort(u_read, kind='stable')
            u_read, u_fs, u_fe, u_sc = (u_read[uo], u_fs[uo], u_fe[uo],
                                        u_sc[uo])
            lo = np.searchsorted(u_read, out.read_idx)
            hi = np.searchsorted(u_read, out.read_idx, side='right')
            counts = hi - lo
            total = int(counts.sum())
            if total:
                sel_rep = np.repeat(np.arange(n_sel), counts)
                offs = np.concatenate([[0], np.cumsum(counts)])[:-1]
                u_idx = (np.arange(total)
                         - np.repeat(offs - lo, counts))
                ov = (np.minimum(fe_sel[sel_rep], u_fe[u_idx])
                      - np.maximum(fs_sel[sel_rep], u_fs[u_idx]))
                ok = ov > 0.5 * span[sel_rep]
                np.maximum.at(s2, sel_rep[ok], u_sc[u_idx[ok]])
                sub_n = np.bincount(sel_rep[ok], minlength=n_sel)
        s1 = out.score.astype(np.float64)
        sub = np.maximum(s2, sub_floor).astype(np.float64)
        l = np.maximum(np.maximum(
            span, (out.rend - out.rstart + 1).astype(np.int64)), 1)
        identity = 1.0 - (l * match_a - s1) / ((match_a + mismatch_b) * l)
        # max(l, 2): np.where evaluates both branches, and log(1) = 0
        # raised a divide-by-zero warning for 1-base spans (discarded by
        # the where, but noisy at every chunk)
        tmp = np.where(l < _MAPQ_COEF_LEN, 1.0,
                       _MAPQ_COEF_FAC / np.log(np.maximum(l, 2)))
        tmp = tmp * identity * identity
        mq = (6.02 * (s1 - sub) / match_a * tmp * tmp + 0.499)
        mq = mq.astype(np.int64)
        pen = (4.343 * np.log(sub_n + 1) + 0.499).astype(np.int64)
        mq = np.where(sub_n > 0, mq - pen, mq)
        mq = np.where((s1 <= 0) | (sub >= s1), 0, mq)
        out.mapq[:] = np.clip(mq, 0, 60)
    out = _zdrop_split_rows(out, ca, sel_idx, regions, ref, config, cat,
                            off)
    _t_fin.__exit__(None, None, None)
    return out



# bwa-mem mapQ model constants (mem_approx_mapq_se defaults):
# score-gap scale 6.02/match, identity damping for alignments longer than
# 50 bp via (log 50 / log l)^?, and a 4.343*ln(n_sub+1) crowd penalty.
_MAPQ_COEF_LEN = 50
_MAPQ_COEF_FAC = float(np.log(_MAPQ_COEF_LEN))


def _bwa_style_mapq(s1: int, s2: int, qspan: int, rspan: int,
                    match_a: int, mismatch_b: int, sub_floor: int,
                    sub_n: int) -> int:
    if s1 <= 0:
        return 0
    sub = max(s2, sub_floor)
    if sub >= s1:
        return 0
    l = max(qspan, rspan, 1)
    identity = 1.0 - (l * match_a - s1) / float((match_a + mismatch_b) * l)
    tmp = 1.0 if l < _MAPQ_COEF_LEN else _MAPQ_COEF_FAC / np.log(l)
    tmp *= identity * identity
    mapq = int(6.02 * (s1 - sub) / match_a * tmp * tmp + 0.499)
    if sub_n > 0:
        mapq -= int(4.343 * np.log(sub_n + 1) + 0.499)
    return int(min(60, max(0, mapq)))


def _zdrop_split_rows(out: Alignments, ca: CandAln,
                      sel_idx: np.ndarray, regions, ref: Reference,
                      config: PipelineConfig, cat, off) -> Alignments:
    """bwa z-drop equivalent (reference bwa invocation -d 200,
    /root/reference/fslr/main.py:125): two true segments whose diagonals
    sit within one band width fuse into ONE seed candidate, and the
    banded extension bridges the junction as a giant indel — bwa's
    z-drop would instead terminate the extension and report two
    alignments.  Here the split happens at CIGAR level: any selected
    alignment with an interior indel run whose affine penalty exceeds
    ``zdrop`` is cut at those runs; each piece's score is replayed on
    the host from query/reference codes (kernel scoring: +match /
    -mismatch, N = mismatch, gap run g costs open + ext*g), pieces
    scoring below the dodi floor (-u 21) are dropped, edge indel runs
    of a piece are trimmed (a local alignment never starts or ends in
    a gap), and primary flags are re-derived (max original score per
    read, collect_mapping_info.py:42-48 semantics).  MAPQ is inherited
    from the fused parent.  Split rows keep their position in the
    emission order; non-split rows are untouched."""
    acfg = config.align
    zdrop = acfg.zdrop
    rle = out.cig_rle
    if not zdrop or rle is None or not len(out) or cat is None:
        return out
    has, cnt, flat_len, flat_op = rle
    if not np.any(has):
        return out
    sc = acfg.scoring
    gap_open = abs(sc.gap_open)
    gap_ext = abs(sc.gap_extend)
    # smallest interior gap with penalty open + ext*g > zdrop
    g_split = (zdrop - gap_open) // gap_ext + 1
    ends = np.cumsum(cnt)
    starts = ends - cnt
    n_rows = len(out)
    seg_row = np.repeat(np.arange(n_rows), cnt)
    big = (flat_len >= g_split) & (flat_op != 0)
    if not np.any(big):
        return out
    cand_rows = np.unique(seg_row[big])

    src_sel = ca.src[sel_idx]
    cmin_sel = ca.ext_cmin[sel_idx]
    match_s = sc.match
    mis_s = sc.mismatch              # negative

    keep_seg = np.ones(len(flat_len), bool)
    pieces_per_row = np.ones(n_rows, np.int64)
    # per split row: list of piece dicts
    row_pieces: dict[int, list] = {}
    for r in cand_rows.tolist():
        sl = flat_len[starts[r]:ends[r]]
        so = flat_op[starts[r]:ends[r]]
        n_seg = len(sl)
        is_big = (sl >= g_split) & (so != 0)
        # piece boundaries: maximal runs of segments between big indels
        bounds = np.flatnonzero(is_big)
        # record-orientation query codes + source ref codes for replay
        ri = int(out.read_idx[r])
        L = int(out.qlen[r])
        o = off[ri]
        if out.strand_rev[r]:
            qrec = _COMP[cat[o:o + L]][::-1]
        else:
            qrec = cat[o:o + L]
        ref_codes = ca.genomes[src_sel[r]][1]
        rabs0 = int(cmin_sel[r] + out.rstart[r])
        # cumulative spans to locate each segment
        qoff = np.zeros(n_seg + 1, np.int64)
        roff = np.zeros(n_seg + 1, np.int64)
        dq = np.where(so != 2, sl, 0)        # M, I consume query
        dr = np.where(so != 1, sl, 0)        # M, D consume reference
        np.cumsum(dq, out=qoff[1:])
        np.cumsum(dr, out=roff[1:])
        q0 = int(out.qstart_o[r])
        lo = 0
        plist = []
        for b in np.append(bounds, n_seg).tolist():
            hi = b                            # segments [lo, hi)
            # trim edge indels (local alignments never end in a gap)
            while lo < hi and so[lo] != 0:
                lo += 1
            hi2 = hi
            while hi2 > lo and so[hi2 - 1] != 0:
                hi2 -= 1
            if hi2 > lo:
                qs = q0 + int(qoff[lo])
                qe = q0 + int(qoff[hi2])
                rs = rabs0 + int(roff[lo])
                re_ = rabs0 + int(roff[hi2])
                # score replay over this piece's runs
                score = 0
                for t in range(lo, hi2):
                    ln = int(sl[t])
                    op = int(so[t])
                    if op == 0:
                        a = qrec[q0 + int(qoff[t]):q0 + int(qoff[t]) + ln]
                        bref = ref_codes[rabs0 + int(roff[t]):
                                         rabs0 + int(roff[t]) + ln]
                        m = int(np.sum((a == bref) & (a < 4) & (bref < 4)))
                        score += m * match_s + (ln - m) * mis_s
                    else:
                        score -= gap_open + gap_ext * ln
                if score >= acfg.min_selected_score:
                    plist.append(dict(lo=lo, hi=hi2, qs=qs, qe=qe,
                                      rs=rs - int(cmin_sel[r]),
                                      re=re_ - int(cmin_sel[r]),
                                      score=int(score)))
            lo = b + 1
        # drop segments outside kept pieces
        seg_keep = np.zeros(n_seg, bool)
        for p in plist:
            seg_keep[p['lo']:p['hi']] = True
        keep_seg[starts[r]:ends[r]] = seg_keep
        pieces_per_row[r] = len(plist)
        row_pieces[r] = plist

    # ---- expand rows ---------------------------------------------------
    rep = np.repeat(np.arange(n_rows), pieces_per_row)
    new_out = Alignments(
        read_idx=out.read_idx[rep], chrom_idx=out.chrom_idx[rep],
        rstart=out.rstart[rep].copy(), rend=out.rend[rep].copy(),
        strand_rev=out.strand_rev[rep],
        qstart_o=out.qstart_o[rep].copy(),
        qend_o=out.qend_o[rep].copy(), qlen=out.qlen[rep],
        score=out.score[rep].copy(), mapq=out.mapq[rep],
        is_primary=np.zeros(len(rep), bool),
        overlaps_region=out.overlaps_region[rep].copy())
    pos_of = np.concatenate([[0], np.cumsum(pieces_per_row)])[:-1]
    new_cnt = np.zeros(len(rep), np.int64)
    new_has = np.zeros(len(rep), bool)
    # every surviving row's FIRST slot starts from the original cnt/has;
    # split rows overwrite all their slots below
    has_slot = pieces_per_row >= 1
    new_cnt[pos_of[has_slot]] = cnt[has_slot]
    new_has[pos_of[has_slot]] = has[has_slot]
    for r, plist in row_pieces.items():
        for k, p in enumerate(plist):
            i = pos_of[r] + k
            new_out.qstart_o[i] = p['qs']
            new_out.qend_o[i] = p['qe']
            new_out.rstart[i] = p['rs']
            new_out.rend[i] = p['re'] - 1     # rend is inclusive
            new_out.score[i] = p['score']
            new_cnt[i] = p['hi'] - p['lo']
            new_has[i] = True
            if regions:
                cname = ref.names[int(new_out.chrom_idx[i])]
                new_out.overlaps_region[i] = _overlaps_region(
                    regions, cname, p['rs'] + 1, p['re'])
    new_out.cig_rle = (new_has, new_cnt, flat_len[keep_seg],
                       flat_op[keep_seg])
    # primary = first max-score alignment per read (unchanged semantics)
    n2 = len(new_out)
    if n2:
        ordr = np.lexsort((np.arange(n2), -new_out.score,
                           new_out.read_idx))
        rid_s = new_out.read_idx[ordr]
        first_m = np.ones(n2, bool)
        first_m[1:] = rid_s[1:] != rid_s[:-1]
        new_out.is_primary[ordr[first_m]] = True
    return new_out


def _no_emits(n: int):
    return (np.zeros(n, bool), np.zeros(n, np.int64),
            np.zeros(0, np.int64), np.zeros(0, np.int64))


def _emit_selected(ca: CandAln, sel_idx: np.ndarray, cat: np.ndarray,
                   off: np.ndarray, config: PipelineConfig,
                   backend: str | None = None, cat_j=None):
    """Traceback-emit extension over the SELECTED candidates only.

    The score pass (_extend_rows) gave every candidate its score, ends
    and (reverse-pass) begins; only the ~15% of candidates that win the
    selection DP ever need a CIGAR, so only they pay the ~17x slower
    emit kernel + path walk (ops/traceback.banded_extend) -- the same
    division of labour as bwa, which only tracebacks alignments it will
    report (/root/reference/fslr/main.py:125 delegates this to bwa).

    Returns (cig_rle, (qstart_o_new, rstart_new)): the columnar RLE form
    (has, cnt, flat_len, flat_op) in selected order -- op codes 0/1/2 =
    M/I/D -- plus walk-derived begin coordinates (on co-optimal ties the
    reverse pass may have picked a different begin than the walk; the
    emitted records must be self-consistent).
    """
    from fslr_tpu.ops import traceback as tbmod
    acfg = config.align
    n = len(sel_idx)
    if not n or not ca.genomes:
        return _no_emits(n), None
    if cat_j is None:
        cat_j = _device_cat(cat)
    has = np.zeros(n, bool)
    cnt = np.zeros(n, np.int64)
    src = ca.src[sel_idx]
    slb = ca.ext_sl[sel_idx].astype(np.int64)
    ri = ca.read_idx[sel_idx]
    sv = ca.strand_rev[sel_idx]
    qlo = ca.ext_qlo[sel_idx]
    kq = ca.ext_qlen[sel_idx]
    Lq = ca.qlen[sel_idx]
    ws = ca.ext_ws[sel_idx]
    cmin = ca.ext_cmin[sel_idx]
    cmax = ca.ext_cmax[sel_idx]
    import jax.numpy as jnp
    keys = (src.astype(np.int64) << 32) | slb
    pending = []
    for key in np.unique(keys):
        gall = np.flatnonzero(keys == key)
        s_ = int(key >> 32)
        SL = int(key & 0xffffffff)
        # chunk rows: the emit kernel's bits tensor costs ~SL*64 B/row of
        # HBM and the walk's per-row index space must stay well under
        # 2^31 words — a 1M-read run puts 100k+ winners in one bucket
        rows_per = max(128, min(32768, (1 << 30) // max(SL * 64, 1)))
        for o in range(0, len(gall), rows_per):
            g = gall[o:o + rows_per]
            # stable shapes: pad ragged tails to a 1024-row multiple
            # (padded results sliced off in the post loop)
            gp = _pad_rows_1k(g)
            with _sub('emit.asm'):
                sf = (off[ri[gp]] + qlo[gp]).astype(np.int32)
                er = (off[ri[gp]] + (Lq[gp] - qlo[gp])).astype(np.int32)
            with _sub('emit.disp'):
                packed_t, emits = dispatch.dp_call(
                    _emit_kernel,
                    (sf, er, sv[gp], kq[gp].astype(np.int32),
                     ws[gp].astype(np.int32), cmin[gp].astype(np.int32),
                     cmax[gp].astype(np.int32)),
                    (cat_j, ca.genomes[s_][0]),
                    statics=(SL, acfg.scoring, backend))
            instrument.add_cells(int(kq[g].sum(dtype=np.int64))
                                 * banded.BW, 'extend')
            pending.append((g, packed_t.T, emits))
    # TWO fetches for ALL groups (one int32, one uint8)
    with _sub('emit.fetch'):
        allp = np.asarray(jnp.concatenate(
            [p.reshape(-1) for (_, p, _) in pending]))
        alle = np.asarray(jnp.concatenate(
            [e.reshape(-1) for (_, _, e) in pending]))
    po = eo = 0
    _t_post = _sub('emit.post'); _t_post.__enter__()
    qs_walk = np.zeros(n, np.int64)
    lf_walk = np.zeros(n, np.int64)
    seg_rows_l, seg_len_l, seg_op_l = [], [], []
    for g, packed, emits in pending:
        psz = int(np.prod(packed.shape))
        esz = int(np.prod(emits.shape))
        p_np = allp[po:po + psz].reshape(packed.shape)[:, :len(g)]
        po += psz
        e_np = alle[eo:eo + esz].reshape(emits.shape)[:len(g)]
        eo += esz
        if _SUBT_ON:
            import sys as _sys
            print(f'emit group: {emits.shape}', file=_sys.stderr)
        _score, _qend, _lane, qstart_c, l_fin = tbmod.finalize_scores(p_np)
        qs_walk[g] = qstart_c
        lf_walk[g] = l_fin
        if _os.environ.get('FSLR_DUMP_EMIT'):
            np.save(_os.environ['FSLR_DUMP_EMIT'], e_np)
        with _sub('emit.rle'):
            sr, sl_, so_ = tbmod.decode_emit_rle(e_np)
        seg_rows_l.append(g[sr])
        seg_len_l.append(sl_)
        seg_op_l.append(so_)
        has[g] = True
    seg_rows = np.concatenate(seg_rows_l)
    seg_len = np.concatenate(seg_len_l).astype(np.int64)
    seg_op = np.concatenate(seg_op_l)
    # group-concat leaves rows unordered ACROSS groups; a stable sort by
    # row restores selected order while keeping within-row op order
    ordr = np.argsort(seg_rows, kind='stable')
    seg_rows = seg_rows[ordr]
    np.add.at(cnt, seg_rows, 1)
    cig_rle = (has, cnt, seg_len[ordr], seg_op[ordr])
    qstart_o_new = qlo + qs_walk
    rstart_new = ws + qs_walk + lf_walk - cmin
    _t_post.__exit__(None, None, None)
    return cig_rle, (qstart_o_new, rstart_new)


def _fwd_span(out: Alignments, i: int):
    if out.strand_rev[i]:
        return (int(out.qlen[i] - out.qend_o[i]),
                int(out.qlen[i] - out.qstart_o[i]))
    return int(out.qstart_o[i]), int(out.qend_o[i])

