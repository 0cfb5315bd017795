"""Multi-device sharded solve demo.

Runs the same deconvolution problem single-device and spot-sharded over all
visible devices, verifying the results agree — the core contract of the
scaling layer. Works on real multi-chip hardware or a virtual CPU mesh:

    # virtual 8-device mesh on CPU:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_solve_demo.py --cpu

    # on the GPUs of one host (uses every device JAX can see):
    python examples/sharded_solve_demo.py

For multi-host clusters, call ``multihost.initialize()`` before anything else —
see ``flashdeconv_tpu/parallel/multihost.py``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if "--cpu" in sys.argv:
    # Some environments register accelerator plugins that override the
    # JAX_PLATFORMS env var; force the CPU backend explicitly.
    jax.config.update("jax_platforms", "cpu")

from flashdeconv_tpu.core.solver import bcd_solve
from flashdeconv_tpu.parallel import halo_fraction, plan_shards, sharded_bcd_solve
from flashdeconv_tpu.utils.graph import banded_split, build_knn_graph, grid_coords


def main() -> None:
    devices = jax.devices()
    print(f"backend={jax.default_backend()}, {len(devices)} device(s)")

    # Synthetic sketched problem on a grid (what the pipeline produces).
    rng = np.random.default_rng(0)
    n_spots, n_types, d = 40_000, 12, 256
    coords = grid_coords(n_spots)
    X_sketch = rng.standard_normal((n_types, d))
    beta_true = np.abs(rng.standard_normal((n_spots, n_types)))
    Y_sketch = beta_true @ X_sketch + 0.05 * rng.standard_normal((n_spots, d))
    A = build_knn_graph(coords, k=6)

    offsets, _, A_rest = banded_split(A, max_offsets=32)  # dispatch's check
    grid_like = offsets.size and A_rest.nnz == 0
    print(f"graph: {A.nnz // 2} edges, "
          f"{'fully banded (GSPMD strategy)' if grid_like else 'irregular (halo strategy)'}")
    if not grid_like:
        plan = plan_shards(A, len(devices), coords=coords)
        print(f"halo fraction at {len(devices)} shards: "
              f"{100 * halo_fraction(plan):.2f}% of rows exchanged per sweep")

    kwargs = dict(lambda_=0.3, rho=0.01, max_iter=60, tol=1e-5)

    t0 = time.perf_counter()
    beta_1, info_1 = bcd_solve(Y_sketch, X_sketch, A, **kwargs)
    print(f"single-device: {time.perf_counter() - t0:.2f}s, "
          f"{info_1['n_iterations']} sweeps")

    t0 = time.perf_counter()
    beta_n, info_n = sharded_bcd_solve(
        Y_sketch, X_sketch, A, coords=coords, **kwargs
    )
    print(f"{info_n['n_shards']}-shard:      {time.perf_counter() - t0:.2f}s, "
          f"{info_n['n_iterations']} sweeps")

    diff = np.abs(beta_n - beta_1).max()
    print(f"max |beta_sharded - beta_single| = {diff:.2e}")
    assert diff < 1e-4, "sharded solve diverged from single-device"
    print("OK: sharded and single-device solves agree.")


if __name__ == "__main__":
    main()
