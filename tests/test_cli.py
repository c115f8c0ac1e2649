"""The argparse CLI keeps every option, default and flag of the original
command line (/root/reference/fslr/main.py:19-40 plus this engine's
additions)."""

import pytest

from fslr_tpu import cli
from fslr_tpu.config import PipelineConfig

REQUIRED = ['--name', 'S', '--out', 'o', '--ref', 'r.fa',
            '--primers', '21q1,17p6']

# option -> default, as the click command line had them
DEFAULTS = {
    'basecalled': None, 'trim_threshold': 0.4, 'keep_temp': False,
    'regions': None, 'bias': 1.05, 'procs': 1, 'n_processes': 1,
    'process_id': 0, 'coordinator': None, 'reference_mask': None,
    'skip_alignment': False, 'skip_clustering': False,
    'jaccard_cutoffs': '1,1,0.66,0.66,0.66,0.5', 'overlap': 0.8,
    'n_alignment_diff': 0.25, 'qlen_diff': 0.04,
    'cluster_mask': 'subtelomere', 'filter_high_coverage': False,
    'filter_false': False, 'run_consensus': False,
    'consensus_engine': 'poa', 'mesh_devices': 0,
}
FLAGS = ['--keep-temp', '--skip-alignment', '--skip-clustering',
         '--filter-high-coverage', '--filter-false', '--consensus']


def test_defaults_match_the_original_command_line():
    args = cli.build_parser().parse_args(REQUIRED)
    got = {k: v for k, v in vars(args).items()
           if k not in ('name', 'out', 'ref', 'primers')}
    assert got == DEFAULTS


@pytest.mark.parametrize('missing', ['--name', '--out', '--ref', '--primers'])
def test_required_options(missing):
    argv = list(REQUIRED)
    i = argv.index(missing)
    del argv[i:i + 2]
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv)


def test_flags_and_values_reach_the_config(tmp_path):
    regions = tmp_path / 'reg.bed'
    regions.write_text('chr1\t1\t2\n')
    args = cli.build_parser().parse_args(REQUIRED + FLAGS + [
        '--trim-threshold', '0.5', '--bias', '1.2', '--procs', '3',
        '--jaccard-cutoffs', '1,0.5', '--cluster-mask', 'chr1,subtelomere',
        '--consensus-engine', 'pileup', '--regions', str(regions),
        '--qlen-diff', '0.1', '--overlap', '0.7', '--n-alignment-diff',
        '0.3'])
    cfg = cli.config_from_args(args)
    assert isinstance(cfg, PipelineConfig)
    assert cfg.keep_temp and cfg.skip_alignment and cfg.skip_clustering
    assert cfg.run_consensus and cfg.consensus.engine == 'pileup'
    assert cfg.cluster.filter_high_coverage and cfg.cluster.filter_false
    assert cfg.primer.trim_threshold == 0.5 and cfg.align.bias == 1.2
    assert cfg.procs == 3 and cfg.regions == str(regions)
    assert cfg.cluster.jaccard_cutoffs == (1.0, 0.5)
    assert cfg.cluster.cluster_mask == ('chr1', 'subtelomere')
    assert cfg.cluster.qlen_diff == 0.1 and cfg.cluster.overlap == 0.7
    assert cfg.cluster.n_alignment_diff == 0.3
    assert cfg.primers == ('21q1', '17p6')


def test_path_options_must_exist_and_engine_is_a_choice(tmp_path):
    p = cli.build_parser()
    with pytest.raises(SystemExit):
        p.parse_args(REQUIRED + ['--regions', str(tmp_path / 'none.bed')])
    with pytest.raises(SystemExit):
        p.parse_args(REQUIRED + ['--reference-mask', str(tmp_path / 'x')])
    with pytest.raises(SystemExit):
        p.parse_args(REQUIRED + ['--consensus-engine', 'abpoa'])


def test_version(capsys):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(['--version'])
    assert '0.1.0' in capsys.readouterr().out
