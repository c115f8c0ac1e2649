"""The column table's TSV format against pandas, the reference's own
library for these artifacts (pandas is a test-only dependency)."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd

from fslr_tpu.table import Table, read_tsv, write_tsv


def _mappings_like(n=40, seed=0, with_missing=True):
    rng = np.random.default_rng(seed)
    cols = {
        'chrom': np.array([f'chr{c}' for c in rng.integers(1, 4, n)], object),
        'rstart': rng.integers(0, 10**7, n),
        'qname': np.array([f'r{i}.1_2.21q1F_False' for i in range(n)],
                          object),
        'strand': np.array(['+', '-'] * (n // 2), object),
        'seq': np.array(['ACGT' * int(k) for k in rng.integers(0, 3, n)],
                        object),
        'score': rng.random(n) * 100,
        'third': np.arange(n) / 3.0,
        'cluster': np.arange(n, dtype=np.float64),
    }
    if with_missing:
        ov = rng.integers(0, 2, n).astype(np.float64)
        ov[::5] = np.nan
        cols['overlaps_region'] = ov
    return Table(cols)


def test_writer_matches_pandas_to_csv(tmp_path):
    t = _mappings_like()
    write_tsv(t, str(tmp_path / 'a.bed'))
    pd.DataFrame(t.to_dict()).to_csv(tmp_path / 'b.bed', sep='\t',
                                     index=False)
    assert (tmp_path / 'a.bed').read_bytes() == \
        (tmp_path / 'b.bed').read_bytes()


def test_comma_writer_matches_pandas(tmp_path):
    t = _mappings_like(with_missing=False).select(['qname', 'score'])
    write_tsv(t, str(tmp_path / 'a.csv'), sep=',')
    pd.DataFrame(t.to_dict()).to_csv(tmp_path / 'b.csv', index=False)
    assert (tmp_path / 'a.csv').read_bytes() == \
        (tmp_path / 'b.csv').read_bytes()


def test_reader_round_trips_and_types_like_pandas(tmp_path):
    path = str(tmp_path / 'a.bed')
    write_tsv(_mappings_like(), path)
    t = read_tsv(path)
    ref = pd.read_csv(path, sep='\t')
    assert t.columns == list(ref.columns)
    for c in t.columns:
        assert (t[c].dtype.kind == 'O') == (ref[c].dtype.kind == 'O'), c
    assert t['rstart'].dtype == np.int64
    assert np.isnan(t['overlaps_region'][0])
    assert t['seq'][t['seq'] == ''].size > 0        # empty text stays ''
    write_tsv(t, str(tmp_path / 'again.bed'))
    assert (tmp_path / 'again.bed').read_bytes() == open(path, 'rb').read()


def test_sort_and_concat_follow_pandas():
    a = Table({'n': np.array([2, 3, 2, 3]),
               'q': np.array(['b', 'a', 'a', 'b'], object),
               'x': np.array([1, 2, 3, 4])})
    b = Table({'n': np.array([3]), 'q': np.array(['a'], object),
               'x': np.array([5]), 'y': np.array([1.5])})
    got = Table.concat([a, b]).sort(['n', 'q'], [False, True])
    df = pd.concat([pd.DataFrame(a.to_dict()), pd.DataFrame(b.to_dict())],
                   ignore_index=True).sort_values(
        ['n', 'q'], ascending=[False, True], kind='stable')
    assert got['x'].tolist() == df['x'].tolist()
    assert got['y'].dtype == np.float64
    assert np.array_equal(got['y'], df['y'].to_numpy(), equal_nan=True)


def test_compile_cache_directory_rule(tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX; otherwise the
    cache sits at one fixed path inside the checkout."""
    code = ('import jax, fslr_tpu; '
            'print(jax.config.jax_compilation_cache_dir)')
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=repo,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == os.path.join(repo, '.jax_cache')
    env['JAX_COMPILATION_CACHE_DIR'] = str(tmp_path / 'c')
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=repo,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == str(tmp_path / 'c')
