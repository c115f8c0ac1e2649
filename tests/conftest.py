"""Test environment.

Tests run on the CPU by default (``JAX_PLATFORMS=cpu``) with a virtual
8-device host platform, the standard JAX way to exercise the shard_map
mesh paths without several accelerators.  Tests marked ``gpu`` exercise
the CUDA kernels; they skip unless JAX's default backend is a GPU, and run
on a card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marked_tests_need_a_card(request):
    """Skip ``gpu``-marked tests where JAX has no GPU.  Decided per test,
    at run time, never while a module is imported."""
    if request.node.get_closest_marker('gpu') is None:
        return
    import jax
    if jax.default_backend() != 'gpu':
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
