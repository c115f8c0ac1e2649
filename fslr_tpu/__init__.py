"""fslr-tpu: split-read fusion-calling engine in JAX.

A from-scratch JAX/XLA implementation of the capabilities of the fslr
pipeline (see SURVEY.md for the reference structural analysis), with CUDA
kernels for the dynamic-programming hot path on NVIDIA GPUs.
"""

import os as _os

__version__ = '0.1.0'

# Persistent XLA compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR
# itself; only when it is unset does the package pick one fixed directory
# inside the checkout, so repeat runs find their compiled programs again.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    '.jax_cache')


def _configure_compile_cache():
    import jax
    if not _os.environ.get('JAX_COMPILATION_CACHE_DIR'):
        jax.config.update('jax_compilation_cache_dir', CACHE_DIR)
    # cache every program: the pipeline compiles dozens of small ones
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.0)


_configure_compile_cache()
