"""Command-line interface, mirroring the reference CLI option-for-option
(/root/reference/fslr/main.py:19-40).  Entry: ``python -m fslr_tpu.cli``,
the ``fslr-tpu`` console script, or :func:`main` with an argument list."""

from __future__ import annotations

import argparse
import os

import fslr_tpu
from fslr_tpu.config import ClusterConfig, PipelineConfig


def _existing_path(p: str) -> str:
    if not os.path.exists(p):
        raise argparse.ArgumentTypeError(f"Path '{p}' does not exist.")
    return p


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog='fslr-tpu',
        description='Split-read fusion calling for long-read PCR amplicons.')
    add = ap.add_argument
    add('--name', required=True, help='Sample name')
    add('--out', required=True, help='Output folder')
    add('--ref', required=True, help='Reference genome')
    add('--primers', required=True,
        help='Comma-separated list of primer names. Make sure these are '
             'listed in primers.csv')
    add('--basecalled', default=None,
        help='Folder of basecalled reads in fastq format to analyse')
    add('--trim-threshold', default=0.4, type=float,
        help='Threshold in range 0-1. Fraction of maximum primer alignment '
             'score; primer sites with lower scores are labelled False '
             '(default: 0.4)')
    add('--keep-temp', action='store_true', help='Keep temp files')
    add('--regions', default=None, type=_existing_path,
        help='Target regions in bed form to perform biased mapping')
    add('--bias', default=1.05, type=float,
        help='Multiply alignment score by bias if alignment falls within '
             'target regions (default: 1.05)')
    add('--procs', default=1, type=int,
        help='Number of processors to use (default: 1)')
    add('--n-processes', default=1, type=int,
        help='Multi-host: total number of pipeline processes (each handles '
             'its input-file shard on its own card; process 0 merges and '
             'clusters) (default: 1)')
    add('--process-id', default=0, type=int,
        help="Multi-host: this process's id in [0, n_processes) "
             '(default: 0)')
    add('--coordinator', default=None,
        help='Multi-host: jax.distributed coordinator address (host:port), '
             'shared by all processes')
    add('--reference-mask', default=None, type=_existing_path,
        help='A bed file containing target regions for creating a masked '
             'reference. Reads are first aligned to the masked reference, '
             'prior to using the main reference')
    add('--skip-alignment', action='store_true', help='Skip alignment step')
    add('--skip-clustering', action='store_true',
        help='Skip clustering step')
    add('--jaccard-cutoffs', default='1,1,0.66,0.66,0.66,0.5',
        help='Comma-separated list of Jaccard similarity thresholds for N-1 '
             'intersections (default: 1,1,0.66,0.66,0.66,0.5)')
    add('--overlap', default=0.8, type=float,
        help='Reciprocal interval overlap in range 0-1. (default: 0.8)')
    add('--n-alignment-diff', default=0.25, type=float,
        help='How much the number of alignments in one cluster can differ. '
             'Fraction in the range 0-1. (default: 0.25)')
    add('--qlen-diff', default=0.04, type=float,
        help='Max difference in query length. Fraction 0-1. '
             '(default: 0.04)')
    add('--cluster-mask', default='subtelomere',
        help="Comma separated list of chromosome names to be excluded from "
             "the clustering. Use 'subtelomere' to exclude alignments "
             'within 500kb of telomere end (default: subtelomere)')
    add('--filter-high-coverage', action='store_true',
        help='Filter regions with high coverage')
    add('--filter-false', action='store_true',
        help='Use reads with both primers labeled')
    add('--consensus', dest='run_consensus', action='store_true',
        help='Run the per-cluster consensus + realign stage (documented in '
             'the reference but shipped disabled there; opt-in here)')
    add('--consensus-engine', default='poa', choices=['poa', 'pileup'],
        help="Consensus engine: 'poa' = profile-graph partial-order "
             "consensus (abpoa-grade), 'pileup' = single-round backbone "
             'vote (faster, less accurate on insertions) (default: poa)')
    add('--mesh-devices', default=0, type=int,
        help='Shard every batched stage kernel data-parallel over this many '
             'devices (0 = all available when >1, 1 = single-device). The '
             'reference parallelizes with --procs worker processes; here '
             'parallelism is a device mesh. (default: 0)')
    add('--version', action='version',
        version=f'%(prog)s, version {fslr_tpu.__version__}')
    return ap


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    cluster = ClusterConfig(
        jaccard_cutoffs=tuple(
            float(x) for x in args.jaccard_cutoffs.split(',')),
        overlap=args.overlap,
        qlen_diff=args.qlen_diff,
        n_alignment_diff=args.n_alignment_diff,
        cluster_mask=tuple(x for x in args.cluster_mask.split(',') if x),
        filter_high_coverage=args.filter_high_coverage,
        filter_false=args.filter_false,
    )
    config = PipelineConfig(
        name=args.name, out=args.out, ref=args.ref,
        primers=tuple(args.primers.split(',')),
        basecalled=args.basecalled, regions=args.regions,
        reference_mask=args.reference_mask,
        keep_temp=args.keep_temp,
        skip_alignment=args.skip_alignment,
        skip_clustering=args.skip_clustering,
        run_consensus=args.run_consensus,
        procs=args.procs, n_processes=args.n_processes,
        process_id=args.process_id, coordinator=args.coordinator,
        cluster=cluster)
    return config.replace(
        consensus=config.consensus.__class__(
            **{**config.consensus.__dict__,
               'engine': args.consensus_engine}),
        primer=config.primer.__class__(
            trim_threshold=args.trim_threshold,
            search_window=config.primer.search_window),
        align=config.align.__class__(
            **{**config.align.__dict__, 'bias': args.bias}))


def main(argv: list[str] | None = None):
    args = build_parser().parse_args(argv)
    from fslr_tpu.pipeline import run_pipeline

    config = config_from_args(args)
    mesh = None
    n_mesh = args.mesh_devices
    if n_mesh == 0 or n_mesh > 1:
        import jax

        from fslr_tpu.parallel.mesh import make_mesh
        n_avail = len(jax.devices())
        want = n_avail if n_mesh == 0 else min(n_mesh, n_avail)
        if want > 1:
            mesh = make_mesh(want)
    run_pipeline(config, mesh=mesh)


if __name__ == '__main__':
    main()
