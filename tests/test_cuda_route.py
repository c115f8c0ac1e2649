"""The kernel route and the CUDA wrappers' shapes, padding and slicing.

The CUDA kernels cannot run here; their wrappers are driven through a
stand-in for the FFI call that honours each target's buffer contract with
the plain JAX path, so what is checked is everything the wrappers do
around the kernel: dtypes, query padding, the (N, 3) / (N, 6) result
layouts and transposes."""

import numpy as np
import jax.numpy as jnp
import pytest

from fslr_tpu.config import ScoringConfig
from fslr_tpu.ops import banded, cuda, ssw
from fslr_tpu.ops import traceback as tb
from tests.oracles import mutate, random_seq

BWA_SC = ScoringConfig(gap_open_is_first_base=False)
SSW_SC = ScoringConfig()


def _twin(name, out_types, *args, **attrs):
    """FFI-call stand-in: the plain path under each target's contract."""
    warps = attrs['warps']
    assert warps.dtype == np.int32 and 1 <= int(warps) <= cuda.MAX_WARPS
    kw = {k: float(attrs[k]) for k in ('match', 'mismatch', 'fg', 'ext')
          if k in attrs}
    for a in args:
        assert a.dtype in (jnp.uint8, jnp.int32, jnp.float32), a.dtype
    if name == 'fslr_banded_score':
        q, w, qlens = args
        assert q.dtype == w.dtype == jnp.uint8
        assert w.shape[1] == q.shape[1] + 256
        s, qe, ln = banded._banded_jax(q, w, qlens, **kw)
        out = jnp.stack([s.astype(jnp.int32), qe, ln], axis=1)
        assert out.shape == out_types.shape
        return out
    if name == 'fslr_banded_extend':
        q, w, qlens = args
        packed, emits = tb.walk_packed(*tb._tb_jax(q, w, qlens, **kw))
        assert emits.shape == out_types[1].shape
        return (packed.T, emits, jnp.zeros(out_types[2].shape, jnp.int32),
                jnp.zeros(out_types[3].shape, jnp.int32))
    if name == 'fslr_sw':
        q, t, qlens, tlens = args
        assert q.shape[1] == 128
        return ssw._sw_jax(q, t, qlens, tlens, **kw)
    if name == 'fslr_sw_packed':
        q, t, tlens = args
        assert q.shape[1] == 128
        return ssw._sw_packed_jax(q, t, tlens, stride=int(attrs['stride']),
                                  **kw)
    raise AssertionError(name)


@pytest.fixture
def twin_ffi(monkeypatch):
    monkeypatch.setattr(cuda, '_call', _twin)


def _banded_case(rng, n, lq):
    q = np.full((n, lq), 4, np.uint8)
    w = rng.integers(0, 4, (n, lq + 256)).astype(np.uint8)
    qlens = np.zeros(n, np.int32)
    for r in range(n):
        read = random_seq(rng, int(rng.integers(lq // 2, lq)))
        seg = mutate(rng, read, sub=0.05, indel=0.03)[:lq + 192]
        q[r, :len(read)] = read
        qlens[r] = len(read)
        w[r, 64:64 + len(seg)] = seg
    return q, w, qlens


def test_kernel_route():
    assert cuda.kernel_route() == 'plain'            # the CPU backend
    assert cuda.kernel_route('jax') == 'plain'
    assert cuda.kernel_route('cuda') == 'cuda'
    with pytest.raises(ValueError):
        cuda.kernel_route('triton')


def test_forced_cuda_route_raises_without_a_card():
    q = np.full((2, 128), 4, np.uint8)
    t = np.zeros((2, 64), np.uint8)
    lens = np.array([10, 10], np.int32)
    with pytest.raises(RuntimeError, match='GPU backend'):
        ssw.sw_max(q, t, lens, lens, SSW_SC, backend='cuda')


def test_warps_per_block():
    assert cuda.warps_per_block(2 * 3072 + 256) == cuda.MAX_WARPS
    assert cuda.warps_per_block(2 * 32768 + 256) == 1
    assert cuda.warps_per_block(20_000) == cuda.SMEM_BUDGET // 20_000
    assert cuda.warps_per_block(0) == cuda.MAX_WARPS


def test_library_name_follows_the_source():
    p = cuda.library_path()
    assert p.parent == cuda.BUILD_DIR and p.suffix == '.so'
    assert p.name.startswith('libfslr_dp_')


def test_banded_score_wrapper(twin_ffi):
    rng = np.random.default_rng(1)
    q, w, qlens = _banded_case(rng, 5, 256)      # 5 rows: not a warp
    got = banded.banded_sw(q, w, qlens, BWA_SC, backend='cuda')
    want = banded.banded_sw(q, w, qlens, BWA_SC, backend='jax')
    for g, e in zip(got, want):
        assert g.dtype == e.dtype and g.shape == (5,)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(e))


def test_banded_extend_wrapper(twin_ffi):
    rng = np.random.default_rng(2)
    q, w, qlens = _banded_case(rng, 3, 128)
    kw = dict(match=2.0, mismatch=-3.0, fg=7.0, ext=2.0)
    gp, ge = tb.extend_windows(q, w, qlens, route='cuda', **kw)
    wp, we = tb.extend_windows(q, w, qlens, route='plain', **kw)
    assert gp.shape == (6, 3) and ge.shape == (3, (128 + 128) // 4)
    np.testing.assert_array_equal(np.asarray(gp), np.asarray(wp))
    np.testing.assert_array_equal(np.asarray(ge), np.asarray(we))
    cigars = tb.finalize_extend(gp, ge)[5]
    assert all(cigars)


def test_sw_wrapper_pads_queries(twin_ffi):
    rng = np.random.default_rng(3)
    n = 7
    q = np.full((n, 40), 4, np.uint8)            # narrower than 128 lanes
    t = np.full((n, 300), 4, np.uint8)
    qlens = np.zeros(n, np.int32)
    tlens = np.zeros(n, np.int32)
    for r in range(n):
        qq = random_seq(rng, int(rng.integers(15, 40)))
        tt = random_seq(rng, int(rng.integers(100, 300)))
        pos = int(rng.integers(0, len(tt) - len(qq)))
        m = mutate(rng, qq, sub=0.05)[:len(qq)]
        tt[pos:pos + len(m)] = m
        q[r, :len(qq)], qlens[r] = qq, len(qq)
        t[r, :len(tt)], tlens[r] = tt, len(tt)
    got = ssw.sw_locate(q, t, qlens, tlens, SSW_SC, backend='cuda')
    want = ssw.sw_locate(q, t, qlens, tlens, SSW_SC, backend='jax')
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]))


def test_sw_packed_wrapper(twin_ffi):
    rng = np.random.default_rng(4)
    primers = [random_seq(rng, 20) for _ in range(4)]
    rows, _, _ = ssw.pack_queries(primers, 32)
    n = 3
    t = rng.integers(0, 4, (n, 400)).astype(np.uint8)
    t[0, 50:70] = primers[2]
    tlens = np.array([400, 300, 0], np.int32)
    q = np.repeat(rows, n, axis=0)
    got = ssw.sw_max_packed(q, t, tlens, SSW_SC, 32, backend='cuda')
    want = ssw.sw_max_packed(q, t, tlens, SSW_SC, 32, backend='jax')
    for g, e in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(e))
    assert float(got[0][0]) == 40.0
