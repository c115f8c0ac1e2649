"""chip_smoke.py's phases at tiny size on the CPU.

On the CPU the kernel phase compares the plain path with itself (the CUDA
route needs a card); what runs here is the data generation, the
comparisons, the CLI drive and the artifact checks of every phase."""

import os

import pytest

import chip_smoke


def test_device_phase_refuses_cpu_without_override():
    with pytest.raises(SystemExit):
        chip_smoke.phase_device()
    dev = chip_smoke.phase_device(allow_cpu=True)
    assert dev['platform'] == 'cpu' and dev['count'] >= 1


def test_kernel_phase_tiny():
    out = chip_smoke.phase_kernels(
        'jax', sl=256, band_rows=5, sw_reads=2, packed_rows=3, repeats=1)
    assert set(out) == {'banded_score', 'banded_emit_walk', 'sw_locate',
                        'sw_max_packed'}
    assert all(v['kernel_s'] > 0 and v['plain_s'] > 0 for v in out.values())


def test_main_path_phase_tiny(tmp_path):
    res = chip_smoke.phase_main_path(str(tmp_path), n_reads=24, n_groups=3,
                                     ref_mb=1_400_000, check_reads=12)
    assert res['clusters'] == 3
    assert res['planted_fraction'] >= 0.99
    assert res['compiles_in_timed_run'] >= 0
    assert res['paths']['encounter_build'] == 'host'
    assert os.path.exists(tmp_path / 'check_jax' / 'S.mappings.cluster.bed')


def test_compare_routes_phase_tiny(tmp_path):
    import bench
    ref, fq_dir = bench.make_dataset(str(tmp_path), 12, n_groups=2,
                                     ref_mb=1_400_000)
    res = chip_smoke.phase_compare_routes(
        str(tmp_path), ref, fq_dir, ['all_plain', 'sw_locate'], repeats=1)
    assert set(res) == {'all_plain', 'sw_locate_plain'}
    for pair in res.values():
        assert len(pair['variant']) == len(pair['default']) == 1
        assert all(wall > 0 and 'align' in stages
                   for wall, stages in pair['variant'] + pair['default'])


def test_consensus_phase_tiny(tmp_path):
    res = chip_smoke.phase_consensus(str(tmp_path), n_reads=12,
                                     n_clusters=3, ref_mb=1_400_000)
    assert res['clusters'] == 3


def test_four_card_phase_on_virtual_devices(tmp_path):
    res = chip_smoke.phase_four_cards(str(tmp_path), n_reads=16, n_groups=2,
                                      ref_mb=1_400_000, n_dev=4)
    assert res['devices'] == 4


def test_planted_fraction_counts_all_three_segments():
    bed = {'qname': ['r0.a.21q1F_17p6R'] * 3 + ['r1.a.21q1F_17p6R'],
           'chrom': ['chrA', 'chrB', 'chrA', 'chrA'],
           'rstart': [1000001, 601000, 1200001, 1000001],
           'rend': [1000800, 600001, 1200800, 1000800]}
    assert chip_smoke._planted_fraction(bed, 2, 2, 1_400_000) == 0.5
