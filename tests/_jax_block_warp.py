"""Pin the JAX package's block warp to the TPU kernel's function on the CPU.

`premvos_tpu.ops.resample2d.resample2d_block` picks its blocks by backend:
(8, 128) for the Pallas kernel on the TPU, (32, 128) for its XLA fallback
on the CPU, and the two are different functions wherever a pixel leaves its
block's window. The port's block warp is the TPU kernel's, so a test that
holds the port against the JAX package imports `jax_tpu_block_warp` (a
module-scoped autouse fixture): while the module runs, the JAX function
runs its XLA path at (8, 128), the blocks of resample2d_block_pallas. Its
callers that take the default blocks (FlowNet2._warp, stages/flow.py's
warp_masks) import it at call time, so they see the pinned one; the lucid
warps pass their blocks. JAX's compiled functions are cleared before and
after, so no trace of the other blocks is reused.
"""

import importlib

import jax
import pytest

# The module itself: premvos_tpu.ops re-exports its `resample2d` function
# under the module's name.
jax_resample2d = importlib.import_module("premvos_tpu.ops.resample2d")

TPU_BLOCK = (8, 128)


@pytest.fixture(scope="module", autouse=True)
def jax_tpu_block_warp():
    real = jax_resample2d.resample2d_block

    def pinned(src, flow, block=None, residual=4, max_flow=64, use_pallas=None):
        return real(src, flow, TPU_BLOCK if block is None else block, residual, max_flow,
                    use_pallas=False)

    jax.clear_caches()
    jax_resample2d.resample2d_block = pinned
    try:
        yield
    finally:
        jax_resample2d.resample2d_block = real
        jax.clear_caches()
