"""Device CountSketch projection: Y (N x G) -> Y_sketch (N x d).

The device path is one dense product ``Y @ dense(Omega)``: Omega dense is
only G x d (a few MB), and the product runs as a full-precision FP32 GEMM
(``precision=HIGHEST``, so no TF32 rounding on the GPU). The host scipy
path and the native sparse kernels live in :mod:`flashdeconv_tpu.core.
sketching`.

Replaces the reference's scipy sparse matmul (reference
``flashdeconv/core/sketching.py:160-206``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def countsketch_project(Y, op, dtype=jnp.float32):
    """Project rows of Y through a CountSketch operator on device.

    Parameters
    ----------
    Y : (N, G) array (host numpy or device array)
    op : :class:`flashdeconv_tpu.core.sketching.CountSketchOp`

    Returns
    -------
    (N, d) device array.
    """
    Y = jnp.asarray(Y, dtype=dtype)
    omega = jnp.asarray(op.to_dense(np.dtype(dtype)), dtype=dtype)
    return _matmul_project(Y, omega)


@jax.jit
def _matmul_project(Y, omega):
    # HIGHEST: the sketch feeds Gram/XtY precomputations where reduced-
    # precision (bf16 / TF32) products would leak into solver parity.
    return jnp.dot(
        Y,
        omega,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
