"""Kernel route and the CUDA kernels behind it.

:func:`kernel_route` is the one place that decides how the DP kernels run:

  * ``'cuda'`` on a GPU backend: the hand kernels of
    ``fslr_tpu/cuda/dp_kernels.cu``, built with ``nvcc`` for sm_90a at
    first use and called through ``jax.ffi``;
  * ``'plain'`` on the CPU, or when a caller passes ``backend='jax'``: the
    ``lax.scan`` implementations next to each kernel (the reference the
    CUDA kernels are checked against).

``backend='cuda'`` forces the CUDA route.  A failed build or load raises;
there is no fallback to the plain path.

The library is built into ``<checkout>/build/`` (listed in .gitignore)
under a name carrying a hash of the source, so an edited source never
loads a stale library.  ``python -m fslr_tpu.ops.cuda`` builds it ahead
of time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / 'cuda' / 'dp_kernels.cu'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

# FFI target name -> exported handler symbol
TARGETS = {
    'fslr_banded_score': 'FslrBandedScore',
    'fslr_banded_extend': 'FslrBandedExtend',
    'fslr_sw': 'FslrSw',
    'fslr_sw_packed': 'FslrSwPacked',
}

# dynamic shared memory a block may take for its rows (of the 227 KB an
# H100 block can address); rows stage their code bytes there
SMEM_BUDGET = 96 * 1024
MAX_WARPS = 8

_lock = threading.Lock()
_registered = False


def kernel_route(backend: str | None = None) -> str:
    """'cuda' or 'plain' for a kernel call (see module docstring)."""
    if backend == 'jax':
        return 'plain'
    if backend == 'cuda':
        return 'cuda'
    if backend is not None:
        raise ValueError(f'unknown kernel backend {backend!r} '
                         f"(expected None, 'jax' or 'cuda')")
    return 'cuda' if jax.default_backend() == 'gpu' else 'plain'


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f'libfslr_dp_{digest}.so'


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found: the CUDA kernel route needs the '
                       'CUDA toolkit to build fslr_tpu/cuda/dp_kernels.cu')


def build() -> Path:
    """Compile the kernel library unless this source's build exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), *NVCC_FLAGS, '-I', jax.ffi.include_dir(),
           '-o', str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                           f'{" ".join(cmd)}\n{proc.stderr[-4000:]}')
    os.replace(tmp, out)
    return out


def ensure_loaded():
    """Build (if needed), load and register the FFI targets once."""
    global _registered
    if _registered:
        return
    with _lock:
        if _registered:
            return
        if jax.default_backend() != 'gpu':
            raise RuntimeError(
                'the CUDA kernel route needs a GPU backend (JAX reports '
                f'{jax.default_backend()!r}); pass backend="jax" for the '
                'plain path')
        lib = ctypes.cdll.LoadLibrary(str(build()))
        for name, sym in TARGETS.items():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, sym)), platform='CUDA')
        _registered = True


def _call(name, out_types, *args, **attrs):
    ensure_loaded()
    return jax.ffi.ffi_call(name, out_types)(*args, **attrs)


def warps_per_block(row_bytes: int, cap: int = MAX_WARPS) -> int:
    """Rows (warps) per thread block: as many as the shared-memory budget
    holds, at most ``cap``, at least one."""
    return int(max(1, min(cap, SMEM_BUDGET // max(int(row_bytes), 1))))


def _i32(v) -> np.int32:
    return np.int32(int(v))


def _scoring_attrs(match, mismatch, fg, ext) -> dict:
    return dict(match=_i32(match), mismatch=_i32(mismatch), fg=_i32(fg),
                ext=_i32(ext))


# ---------------------------------------------------------------------------
# Wrappers: same arguments and results as the plain functions they replace
# ---------------------------------------------------------------------------

def banded_score(q, w, qlens, *, match, mismatch, fg, ext):
    """ops/banded._banded_jax contract: (score f32, qend, lane)."""
    q = jnp.asarray(q).astype(jnp.uint8)
    w = jnp.asarray(w).astype(jnp.uint8)
    n, lq = q.shape
    out = _call('fslr_banded_score',
                jax.ShapeDtypeStruct((n, 3), jnp.int32),
                q, w, jnp.asarray(qlens, jnp.int32),
                warps=_i32(warps_per_block(2 * lq + 256)),
                **_scoring_attrs(match, mismatch, fg, ext))
    return out[:, 0].astype(jnp.float32), out[:, 1], out[:, 2]


def banded_extend(q, w, qlens, *, match, mismatch, fg, ext):
    """Traceback emit + path walk: (packed (6, N) int32 [score, qend,
    lane, qstart, l_fin, n_ops], emits (N, (Lq+128)/4) uint8), the
    ops/traceback._extend_walk_impl result format."""
    q = jnp.asarray(q).astype(jnp.uint8)
    w = jnp.asarray(w).astype(jnp.uint8)
    n, lq = q.shape
    res, emits, _ends, _bits = _call(
        'fslr_banded_extend',
        (jax.ShapeDtypeStruct((n, 6), jnp.int32),
         jax.ShapeDtypeStruct((n, (lq + 128) // 4), jnp.uint8),
         jax.ShapeDtypeStruct((n, 3), jnp.int32),
         jax.ShapeDtypeStruct((n, lq // 8, 128), jnp.int32)),
        q, w, jnp.asarray(qlens, jnp.int32),
        warps=_i32(warps_per_block(2 * lq + 256)),
        **_scoring_attrs(match, mismatch, fg, ext))
    return res.T, emits


def _pad_queries(q):
    q = jnp.asarray(q).astype(jnp.uint8)
    if q.shape[1] < 128:
        q = jnp.pad(q, [(0, 0), (0, 128 - q.shape[1])], constant_values=4)
    return q


def _sw_out_types(n):
    return (jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
            jax.ShapeDtypeStruct((n,), jnp.int32))


def sw_max(q, t, qlens, tlens, *, match, mismatch, fg, ext):
    """ops/ssw._sw_jax contract: (score f32, target_end, query_end)."""
    q = _pad_queries(q)
    t = jnp.asarray(t).astype(jnp.uint8)
    n, tl = t.shape
    return _call('fslr_sw', _sw_out_types(n), q, t,
                 jnp.asarray(qlens, jnp.int32), jnp.asarray(tlens, jnp.int32),
                 warps=_i32(warps_per_block(tl)),
                 **_scoring_attrs(match, mismatch, fg, ext))


def sw_max_packed(q, t, tlens, *, match, mismatch, fg, ext, stride):
    """ops/ssw._sw_packed_jax contract: (score f32, target_end,
    lane_of_best)."""
    q = _pad_queries(q)
    t = jnp.asarray(t).astype(jnp.uint8)
    n, tl = t.shape
    return _call('fslr_sw_packed', _sw_out_types(n), q, t,
                 jnp.asarray(tlens, jnp.int32), stride=_i32(stride),
                 warps=_i32(warps_per_block(tl)),
                 **_scoring_attrs(match, mismatch, fg, ext))


if __name__ == '__main__':
    print(build())
