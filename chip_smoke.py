#!/usr/bin/env python
"""Smoke test of fslr-tpu on one NVIDIA GPU.

    python chip_smoke.py                # phases 0-4 on one card
    python chip_smoke.py --four-cards   # the 4-card mesh path vs one card

Phases (each a function the tests call at tiny size on the CPU):

  0. device: JAX's platform, device kind and count, and the card's name
     and power limit from nvidia-smi (run in a child that never imports
     JAX).  Anything but a GPU backend exits non-zero: no CPU fallback.
  1. build: compile and load the CUDA kernel library.
  2. kernels: every CUDA kernel against its plain JAX path at real widths,
     with the median of warm timings of both.
  3. main path: the CLI entry point on 10k reads against two seeded
     48 Mbp contigs; a 1k-read run through backend='jax' must give
     byte-identical artifacts.
  4. consensus: --consensus on 2k reads in 100 clusters.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}; any failed phase
exits non-zero before it.  Results also go to chiprun_out/smoke.json.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, 'chiprun_out')     # results (smoke.json)
WORK_DIR = os.path.join(HERE, 'smoke_out')      # datasets, removed after
PRIMERS = ('21q1', '17p6')
REPEATS = 5


def log(*parts):
    print(*parts, flush=True)


_RESULT: dict = {}


def _save(key: str, value):
    """Record a phase result in chiprun_out/smoke.json as soon as it
    exists, so a later failure keeps what was measured."""
    _RESULT[key] = value
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'smoke.json'), 'w') as fh:
        json.dump(_RESULT, fh, indent=1, default=str)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` as printed (a child
    process: the parent stays the only process that opens the card)."""
    try:
        r = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi unavailable ({e})'
    return r.stdout.strip() or f'nvidia-smi failed: {r.stderr.strip()}'


# ---------------------------------------------------------------------------
# phase 0 / 1
# ---------------------------------------------------------------------------

def phase_device(allow_cpu: bool = False) -> dict:
    import jax
    devs = jax.devices()
    dev = {'platform': devs[0].platform, 'kind': devs[0].device_kind,
           'count': len(devs)}
    log(f'[0] device: {dev}')
    if jax.default_backend() != 'gpu' and not allow_cpu:
        raise SystemExit(f'JAX found no GPU (default backend '
                         f'{jax.default_backend()!r}); nothing to test')
    return dev


def phase_build() -> float:
    from fslr_tpu.ops import cuda
    t0 = time.perf_counter()
    cuda.ensure_loaded()
    dt = time.perf_counter() - t0
    log(f'[1] CUDA kernel library {cuda.library_path().name}: '
        f'built and loaded in {dt:.2f} s')
    return dt


# ---------------------------------------------------------------------------
# phase 2: kernels at real widths
# ---------------------------------------------------------------------------

def _median_s(fn, repeats: int) -> float:
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def _mutate(rng, s: np.ndarray, sub: float, indel: float) -> np.ndarray:
    s = s.copy()
    flip = rng.random(len(s)) < sub
    s[flip] = (s[flip] + rng.integers(1, 4, int(flip.sum()))) % 4
    n_ind = rng.binomial(len(s), indel)
    for p in np.unique(rng.integers(0, len(s), n_ind))[::-1]:
        if rng.random() < 0.5:
            s = np.delete(s, p)
        else:
            s = np.insert(s, p, rng.integers(0, 4, int(rng.integers(1, 4))))
    return s.astype(np.uint8)


def banded_inputs(rng, n: int, sl: int):
    """Reads and reference windows holding a mutated copy of the read at
    band offset 64 (the layout of stages/align.py's extension)."""
    q = np.full((n, sl), 4, np.uint8)
    w = rng.integers(0, 4, (n, sl + 256)).astype(np.uint8)
    qlens = rng.integers(sl // 2, sl + 1, n).astype(np.int32)
    for r in range(n):
        read = rng.integers(0, 4, int(qlens[r])).astype(np.uint8)
        q[r, :len(read)] = read
        seg = _mutate(rng, read, 0.05, 0.01)[:sl + 256 - 64]
        w[r, 64:64 + len(seg)] = seg
    return q, w, qlens


def sw_inputs(rng, n: int, tl: int, targets: list[np.ndarray]):
    """Every (target, orientation) against read ends of length <= tl, a
    mutated target planted in half the rows."""
    m = len(targets)
    q = np.full((n, 128), 4, np.uint8)
    qlens = np.zeros(n, np.int32)
    t = rng.integers(0, 4, (n, tl)).astype(np.uint8)
    tlens = rng.integers(tl // 2, tl + 1, n).astype(np.int32)
    for r in range(n):
        tc = targets[r % m]
        q[r, :len(tc)] = tc
        qlens[r] = len(tc)
        t[r, tlens[r]:] = 4
        if r % 2 == 0:
            p = _mutate(rng, tc, 0.05, 0.02)
            pos = int(rng.integers(0, max(1, tlens[r] - len(p))))
            t[r, pos:pos + len(p)] = p[:tl - pos]
    return q, t, qlens, tlens


def phase_kernels(kernel_backend: str = 'cuda', sl: int = 3072,
                  band_rows: int = 5461, sw_reads: int = 4096,
                  packed_rows: int = 8192, repeats: int = REPEATS) -> dict:
    """Each hand kernel against the plain path: equal results and the
    median warm time of both."""
    import jax.numpy as jnp

    from fslr_tpu.config import JunkFilterConfig, PipelineConfig, \
        ScoringConfig
    from fslr_tpu.encode import encode, revcomp
    from fslr_tpu.ops import banded, ssw
    from fslr_tpu.ops import traceback as tb
    from fslr_tpu.panel import load_panel

    rng = np.random.default_rng(2024)
    out = {}
    kb = kernel_backend
    log('[2] no matrix product runs on the device (the one in ops/poa.py '
        'is numpy), so TF32 does not arise; DP scores are integers')

    def record(name, fast_s, plain_s, widths):
        out[name] = {'kernel_s': fast_s, 'plain_s': plain_s,
                     'widths': widths}
        log(f'[2] {name} {widths}: kernel {fast_s * 1e3:.3f} ms, plain '
            f'{plain_s * 1e3:.3f} ms (median of {repeats} warm runs)')

    # banded score + emit: SL = 3072, 5461 rows (stages/align.py chunking)
    bwa = PipelineConfig().align.scoring
    q, w, qlens = banded_inputs(rng, band_rows, sl)
    qd, wd, qld = jnp.asarray(q), jnp.asarray(w), jnp.asarray(qlens)
    runs = {b: (lambda b=b: banded.banded_sw(qd, wd, qld, bwa, backend=b))
            for b in (kb, 'jax')}
    got, want = runs[kb](), runs['jax']()
    for a, b_, what in zip(got, want, ('score', 'qend', 'lane')):
        if not np.array_equal(np.asarray(a), np.asarray(b_)):
            raise AssertionError(f'banded score: {what} differs')
    record('banded_score', _median_s(runs[kb], repeats),
           _median_s(runs['jax'], repeats), f'SL={sl} rows={band_rows}')

    kw = dict(match=float(bwa.match), mismatch=float(bwa.mismatch),
              fg=ssw.first_gap_cost(bwa), ext=float(bwa.gap_extend))
    routes = {kb: 'cuda' if kb == 'cuda' else 'plain', 'jax': 'plain'}
    runs = {b: (lambda b=b: tb.extend_windows(qd, wd, qld, route=routes[b],
                                              **kw))
            for b in (kb, 'jax')}
    (gp, ge), (wp, we) = runs[kb](), runs['jax']()
    if not (np.array_equal(np.asarray(gp), np.asarray(wp))
            and np.array_equal(np.asarray(ge), np.asarray(we))):
        raise AssertionError('banded emit: ends, begins or CIGAR streams '
                             'differ')
    cigars = tb.finalize_extend(gp, ge)[5]
    if sum(len(c) > 1 for c in cigars) < band_rows // 2:
        raise AssertionError('banded emit: too few gapped alignments to '
                             'exercise the walk')
    record('banded_emit_walk', _median_s(runs[kb], repeats),
           _median_s(runs['jax'], repeats), f'SL={sl} rows={band_rows}')

    # sw_locate: 500 bp read ends x every (target, orientation) of the panel
    panel = load_panel()
    targets = [encode(panel.targets[k]) for k in panel.names]
    targets += [revcomp(t) for t in targets]
    ssw_sc = ScoringConfig()
    n = sw_reads * len(targets)
    q, t, ql, tl = sw_inputs(rng, n, 512, targets)
    args = [jnp.asarray(a) for a in (q, t, ql, tl)]
    runs = {b: (lambda b=b: ssw.sw_locate(*args, ssw_sc, backend=b))
            for b in (kb, 'jax')}
    got, want = runs[kb](), runs['jax']()
    for k in want:
        if not np.array_equal(np.asarray(got[k]), np.asarray(want[k])):
            raise AssertionError(f'sw_locate: {k} differs')
    record('sw_locate', _median_s(runs[kb], repeats),
           _median_s(runs['jax'], repeats),
           f'{sw_reads} reads x {len(targets)} targets, 500 bp ends')

    # sw_max_packed: 10 kb concatemer windows, all primers lane-packed
    cfg = JunkFilterConfig()
    prims = [encode(p) for p in panel.seqs.values()]
    prims += [revcomp(p) for p in prims]
    maxp = max(len(p) for p in prims)
    stride = 32
    while stride < maxp:
        stride *= 2
    qrows, _, _ = ssw.pack_queries(prims, stride)
    wt = cfg.chunk_size + 2 * (maxp + cfg.chunk_overlap_pad) + 64
    _, t, _, tl = sw_inputs(rng, packed_rows, wt, prims)
    q = qrows[np.arange(packed_rows) % len(qrows)]
    args = [jnp.asarray(a) for a in (q, t, tl)]
    runs = {b: (lambda b=b: ssw.sw_max_packed(*args, ssw_sc, stride,
                                              backend=b))
            for b in (kb, 'jax')}
    got, want = runs[kb](), runs['jax']()
    for a, b_, what in zip(got, want, ('score', 'tend', 'lane')):
        if not np.array_equal(np.asarray(a), np.asarray(b_)):
            raise AssertionError(f'sw_max_packed: {what} differs')
    record('sw_max_packed', _median_s(runs[kb], repeats),
           _median_s(runs['jax'], repeats),
           f'{packed_rows} windows of {wt} bp')

    return out


# ---------------------------------------------------------------------------
# phase 3: main path through the CLI
# ---------------------------------------------------------------------------

class CompileCounter:
    """Counts XLA backend compilations while ``active``."""
    _instance = None

    def __init__(self):
        import jax
        self.active = False
        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kwargs):
        if self.active and event == '/jax/core/compile/backend_compile_duration':
            self.n += 1

    @classmethod
    @contextlib.contextmanager
    def window(cls):
        if cls._instance is None:
            cls._instance = cls()
        c = cls._instance
        c.n, c.active = 0, True
        try:
            yield c
        finally:
            c.active = False


def _cli_argv(out: str, ref: str, fq_dir: str, extra=()) -> list[str]:
    return ['--name', 'S', '--out', out, '--ref', ref,
            '--primers', ','.join(PRIMERS), '--basecalled', fq_dir,
            '--mesh-devices', '1', *extra]


def _planted_fraction(bed, n_reads: int, n_groups: int,
                      ref_mb: int) -> float:
    """Share of reads whose mapping rows cover all three segments that
    bench.make_dataset planted (chrA:1.0M, chrB:breakpoint, chrA:1.2M)."""
    span = max(1, min(40_000, (ref_mb - 700_000) // n_groups))
    hits: dict[int, set] = {}
    for q, chrom_r, rs, re_ in zip(bed['qname'], bed['chrom'],
                                   bed['rstart'], bed['rend']):
        i = int(q.split('.')[0][1:])
        lo, hi = min(rs, re_), max(rs, re_)
        bpos = 600_000 + (i % n_groups) * span
        for k, (chrom, s, e) in enumerate((
                ('chrA', 1_000_000, 1_000_800), ('chrB', bpos, bpos + 1000),
                ('chrA', 1_200_000, 1_200_800))):
            if chrom_r == chrom and lo < e and s < hi:
                hits.setdefault(i, set()).add(k)
    return sum(len(v) == 3 for v in hits.values()) / n_reads


def _subset_fastq(src_dir: str, dst_dir: str, n: int):
    os.makedirs(dst_dir, exist_ok=True)
    with open(os.path.join(src_dir, 'b0.fastq')) as fh:
        lines = [next(fh) for _ in range(4 * n)]
    with open(os.path.join(dst_dir, 'b0.fastq'), 'w') as fh:
        fh.writelines(lines)


def phase_main_path(root: str, n_reads: int = 10_000, n_groups: int = 20,
                    ref_mb: int = 48_000_000,
                    check_reads: int = 1000) -> dict:
    import jax

    import bench
    from fslr_tpu import cli, instrument
    from fslr_tpu.config import PipelineConfig
    from fslr_tpu.pipeline import _read_counts_csv, run_pipeline
    from fslr_tpu.table import read_tsv

    t0 = time.perf_counter()
    ref, fq_dir = bench.make_dataset(root, n_reads, n_groups=n_groups,
                                     ref_mb=ref_mb)
    log(f'[3] dataset: {n_reads} reads, 2 x {ref_mb} bp contigs in '
        f'{time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    cli.main(_cli_argv(os.path.join(root, 'warm'), ref, fq_dir))
    warm_s = time.perf_counter() - t0
    out = os.path.join(root, 'timed')
    with CompileCounter.window() as cc:
        t0 = time.perf_counter()
        cli.main(_cli_argv(out, ref, fq_dir))
        wall = time.perf_counter() - t0
    compiles = cc.n

    counts = _read_counts_csv(os.path.join(out,
                                           'S.filter_counts_summary.csv'))
    if counts['total_kept'] != n_reads:
        raise AssertionError(f'total_kept {counts["total_kept"]} != '
                             f'{n_reads}')
    planted = _planted_fraction(read_tsv(os.path.join(out, 'S.mappings.bed')),
                                n_reads, n_groups, ref_mb)
    if planted < 0.99:
        raise AssertionError(f'only {planted:.4f} of reads carry their '
                             f'three planted segments')
    n_clusters = len(set(read_tsv(os.path.join(
        out, 'S.mappings.cluster.bed'))['cluster'].tolist()))
    if n_clusters != n_groups:
        raise AssertionError(f'{n_groups} groups gave {n_clusters} clusters')
    with open(os.path.join(out, 'S.timings.json')) as fh:
        stages = json.load(fh)['timings_s']
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get('peak_bytes_in_use', 'not measured')
    res = {'reads': n_reads, 'warmup_wall_s': warm_s, 'wall_s': wall,
           'reads_per_s': n_reads / wall, 'compiles_in_timed_run': compiles,
           'stage_s': stages, 'peak_bytes_in_use': peak,
           'planted_fraction': planted, 'clusters': n_clusters,
           'paths': instrument.paths()}
    log(f'[3] main path: {n_reads} reads in {wall:.3f} s '
        f'({n_reads / wall:.1f} reads/s; warm-up run {warm_s:.1f} s), '
        f'{compiles} compiles in the timed run')
    log(f'[3] stages (s): {json.dumps(stages)}')
    log(f'[3] peak_bytes_in_use {peak}; encounter build path '
        f'{instrument.paths().get("encounter_build")}; planted segments '
        f'found for {planted:.4f} of reads; {n_clusters} clusters')

    # the plain path on the same card must give the same artifacts
    sub_dir = os.path.join(root, 'reads_sub')
    _subset_fastq(fq_dir, sub_dir, check_reads)
    walls = {}
    for b in ('jax', None):
        o = os.path.join(root, f'check_{b or "default"}')
        t0 = time.perf_counter()
        run_pipeline(PipelineConfig(name='S', out=o, ref=ref,
                                    primers=PRIMERS, basecalled=sub_dir),
                     backend=b)
        walls[b or 'default'] = time.perf_counter() - t0
    for art in ('S.mappings.bed', 'S.mappings.cluster.bed'):
        a = os.path.join(root, 'check_jax', art)
        b_ = os.path.join(root, 'check_default', art)
        if not filecmp.cmp(a, b_, shallow=False):
            raise AssertionError(f'{art}: backend="jax" and the default '
                                 f'route differ on {check_reads} reads')
    log(f'[3] {check_reads} reads: backend="jax" and default-route '
        f'artifacts byte-identical (first-run walls, compiles included: '
        f'{json.dumps(walls)})')
    res['check_walls_s'] = walls
    res['dataset'] = (ref, fq_dir)
    return res


def _plain_twins() -> dict:
    """Each CUDA wrapper's plain JAX twin, by kernel name."""
    from fslr_tpu.ops import banded, ssw
    from fslr_tpu.ops import traceback as tb

    return {
        'banded_score': ('banded_score', banded._banded_jax),
        'banded_emit_walk': ('banded_extend',
                             lambda q, w, ql, **kw: tb.walk_packed(
                                 *tb._tb_jax(q, w, ql, **kw))),
        'sw_locate': ('sw_max', ssw._sw_jax),
        'sw_max_packed': ('sw_max_packed', ssw._sw_packed_jax),
    }


@contextlib.contextmanager
def _kernel_on_plain_path(name: str):
    """Run one kernel family on its plain path (all others stay CUDA).
    Traces capture the kernel they were built with, so the caller drops
    compiled programs (``jax.clear_caches``) before each run."""
    from fslr_tpu.ops import cuda
    attr, twin = _plain_twins()[name]
    orig = getattr(cuda, attr)
    setattr(cuda, attr, twin)
    try:
        yield
    finally:
        setattr(cuda, attr, orig)


def phase_compare_routes(root: str, ref: str, fq_dir: str,
                         variants=None, repeats: int = 10) -> dict:
    """End-to-end walls on the phase-3 dataset, in alternating turns (the
    side that runs first swaps every turn).  Variants: ``all_plain``, the
    default (CUDA) route against backend='jax'; and each CUDA kernel
    alone swapped for its plain twin (names of ``_plain_twins``).
    ``variants`` selects which; all by default.  A kernel swap changes
    what a trace captures, so those pairs drop compiled programs before
    every run of both sides and reload them from the persistent cache;
    the ``all_plain`` pair keeps both routes compiled."""
    import io

    import jax

    from fslr_tpu.config import PipelineConfig
    from fslr_tpu.pipeline import run_pipeline

    def run(b, tag, fresh):
        if fresh:
            jax.clear_caches()
        o = os.path.join(root, f'cmp_{tag}')
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            run_pipeline(PipelineConfig(name='S', out=o, ref=ref,
                                        primers=PRIMERS, basecalled=fq_dir),
                         backend=b)
        wall = time.perf_counter() - t0
        with open(os.path.join(o, 'S.timings.json')) as fh:
            stages = json.load(fh)['timings_s']
        return wall, stages

    def turns(tag, ctx, b, fresh):
        with ctx():
            run(b, f'{tag}_warm', fresh)
        out = {'variant': [], 'default': []}
        for r in range(repeats):
            for side in (('variant', 'default') if r % 2 == 0
                         else ('default', 'variant')):
                if side == 'variant':
                    with ctx():
                        out[side].append(run(b, f'{tag}_{r}', fresh))
                else:
                    out[side].append(run(None, f'{tag}_default_{r}', fresh))
        walls = {k: [w for w, _ in v] for k, v in out.items()}
        wins = sum(d < v for v, d in zip(walls['variant'], walls['default']))
        log(f'[5] {tag}: walls (s) {json.dumps(walls)}; default faster in '
            f'{wins} of {repeats} turns')
        _save(f'routes.{tag}', out)
        return out

    names = ['all_plain', *_plain_twins()] if variants is None else variants
    res = {}
    for name in names:
        if name == 'all_plain':
            res[name] = turns(name, contextlib.nullcontext, 'jax', False)
        else:
            res[f'{name}_plain'] = turns(
                f'{name}_plain', lambda n=name: _kernel_on_plain_path(n),
                None, True)
    return res


# ---------------------------------------------------------------------------
# phase 4: consensus
# ---------------------------------------------------------------------------

def phase_consensus(root: str, n_reads: int = 2000, n_clusters: int = 100,
                    ref_mb: int = 6_000_000) -> dict:
    import bench
    from fslr_tpu import cli

    os.makedirs(root, exist_ok=True)
    ref, fq_dir = bench.make_dataset(root, n_reads, n_groups=n_clusters,
                                     ref_mb=ref_mb)
    out = os.path.join(root, 'cons')
    t0 = time.perf_counter()
    cli.main(_cli_argv(out, ref, fq_dir, ['--consensus']))
    wall = time.perf_counter() - t0
    fa = os.path.join(out, 'cluster', 'S.cluster.consensus.fa')
    with open(fa) as fh:
        n_cons = sum(1 for ln in fh if ln.startswith('>'))
    if n_cons != n_clusters:
        raise AssertionError(f'{n_cons} consensus sequences for '
                             f'{n_clusters} clusters')
    for art in ('S.mappings_merged.bed', 'S.bwa_dodi_merged.bam'):
        if not os.path.getsize(os.path.join(out, art)):
            raise AssertionError(f'{art} missing or empty')
    log(f'[4] consensus: {n_cons} consensus sequences for {n_clusters} '
        f'clusters, merged artifacts written ({wall:.1f} s, first run)')
    return {'reads': n_reads, 'clusters': n_clusters, 'wall_s': wall}


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four_cards(root: str, n_reads: int = 10_000, n_groups: int = 20,
                     ref_mb: int = 48_000_000, n_dev: int = 4) -> dict:
    """The phase-3 dataset over a 4-device mesh and on one device, in one
    process; the artifacts must be byte-identical."""
    import jax

    import bench
    from fslr_tpu.config import PipelineConfig
    from fslr_tpu.parallel.mesh import make_mesh
    from fslr_tpu.pipeline import run_pipeline

    if len(jax.devices()) < n_dev:
        raise SystemExit(f'--four-cards needs {n_dev} devices, JAX sees '
                         f'{len(jax.devices())}')
    ref, fq_dir = bench.make_dataset(root, n_reads, n_groups=n_groups,
                                     ref_mb=ref_mb)
    walls = {}
    for tag, mesh in (('mesh', make_mesh(n_dev)), ('one', None),
                      ('mesh_warm', make_mesh(n_dev))):
        o = os.path.join(root, tag)
        t0 = time.perf_counter()
        run_pipeline(PipelineConfig(name='S', out=o, ref=ref,
                                    primers=PRIMERS, basecalled=fq_dir),
                     mesh=mesh)
        walls[tag] = time.perf_counter() - t0
    for art in ('S.mappings.bed', 'S.mappings.cluster.bed',
                'S.mappings.representative.bed', 'S.bwa_dodi.bam'):
        for tag in ('mesh', 'mesh_warm'):
            if not filecmp.cmp(os.path.join(root, tag, art),
                               os.path.join(root, 'one', art),
                               shallow=False):
                raise AssertionError(f'{art}: {n_dev}-device mesh and one '
                                     f'device differ')
    log(f'[4c] {n_reads} reads over a {n_dev}-device mesh and on one '
        f'device: artifacts byte-identical; walls (s) {json.dumps(walls)}')
    return {'reads': n_reads, 'devices': n_dev, 'walls_s': walls}


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the 4-card mesh path and its one-card '
                         'comparison')
    ap.add_argument('--phases', default='0,1,2,3,4',
                    help='comma-separated subset of phases to run')
    ap.add_argument('--compare-routes', nargs='?', const='all',
                    default=None, metavar='VARIANTS',
                    help='after phase 3, time the pipeline end to end on '
                         'the default route against backend="jax" '
                         '(all_plain) and against each CUDA kernel alone on '
                         'its plain path (or only the comma-separated '
                         'VARIANTS)')
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)

    dev = phase_device()
    log(card_line())
    _RESULT.clear()
    _save('device', dev)
    _save('card', card_line())
    os.makedirs(WORK_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix='run_', dir=WORK_DIR) as root, \
            contextlib.redirect_stdout(sys.stderr):
        if args.four_cards:
            _save('four_cards', phase_four_cards(root))
        else:
            phases = {int(p) for p in args.phases.split(',')}
            if 1 in phases:
                _save('build_s', phase_build())
            if 2 in phases:
                _save('kernels', phase_kernels())
            if 3 in phases:
                main_path = phase_main_path(root)
                _save('main_path', main_path)
                if args.compare_routes:
                    phase_compare_routes(
                        root, *main_path['dataset'],
                        None if args.compare_routes == 'all'
                        else args.compare_routes.split(','))
            if 4 in phases:
                _save('consensus', phase_consensus(
                    os.path.join(root, 'consensus')))
    log(card_line())
    log(json.dumps({'ok': True, 'device': dev}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
