"""Scaling-efficiency benchmark: spots/s vs shard count on the local mesh.

Measures the sharded BCD solve at 1..n_devices shards on a fixed problem and
reports parallel efficiency (spots/s per shard relative to 1 shard). On a
real multi-chip slice this produces the scaling-efficiency figure targeted
in BASELINE.md (>=80% from 1 chip to N); on a single-chip or virtual-CPU
mesh it validates the path functionally (efficiency numbers are then not
meaningful — flagged in the output).

Usage:
    python benchmarks/scaling.py [--spots 250000] [--reps 3]
    # virtual 8-device CPU mesh (--cpu forces the backend in-process;
    # accelerator plugins override the JAX_PLATFORMS env var):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python benchmarks/scaling.py --spots 100000 --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spots", type=int, default=250_000)
    ap.add_argument("--types", type=int, default=20)
    ap.add_argument("--sketch-dim", type=int, default=512)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-iter", type=int, default=30)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend in-process (accelerator "
                         "plugins override JAX_PLATFORMS)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    from flashdeconv_tpu.parallel import prepare_sharded_bcd
    from flashdeconv_tpu.utils.graph import build_knn_graph, grid_coords

    devices = jax.devices()
    shard_counts = sorted({s for s in (1, 2, 4, 8, 16, 32, len(devices))
                           if s <= len(devices)})
    print(f"# backend={jax.default_backend()} devices={len(devices)} "
          f"shard_counts={shard_counts}", file=sys.stderr)

    rng = np.random.default_rng(0)
    n, k, d = args.spots, args.types, args.sketch_dim
    coords = grid_coords(n)
    X_sketch = rng.standard_normal((k, d)).astype(np.float32)
    beta_true = np.abs(rng.standard_normal((n, k))).astype(np.float32)
    Y_sketch = beta_true @ X_sketch
    Y_sketch += 0.05 * rng.standard_normal((n, d)).astype(np.float32)
    A = build_knn_graph(coords, k=6)

    if args.reps < 1:
        ap.error("--reps must be >= 1 (rep 0 is the compile warmup)")

    solve_kwargs = dict(lambda_=0.2, rho=0.01, max_iter=args.max_iter,
                        tol=1e-12)
    rows = []
    for s in shard_counts:
        mesh = Mesh(np.asarray(devices[:s]), ("spots",))
        # Prepare ONCE per shard count and time only warm solves: the host
        # precompute (Xty gemm, banded split / Morton ordering, device
        # scatter) is a shard-count-independent serial cost — timing it
        # inside every rep would make 'efficiency' collapse toward 1/s
        # regardless of how well the solve itself scales.
        problem = prepare_sharded_bcd(
            Y_sketch, X_sketch, A, coords=coords, mesh=mesh,
        )
        best = float("inf")
        n_iter = 0
        for rep in range(args.reps + 1):  # rep 0 = compile warmup
            t0 = time.perf_counter()
            beta, info = problem.solve(**solve_kwargs)
            dt = time.perf_counter() - t0
            if rep > 0:
                best = min(best, dt)
            n_iter = info["n_iterations"]
        rows.append({"n_shards": s, "seconds": round(best, 3),
                     "spots_per_sec": round(n / best, 1),
                     "n_iterations": n_iter})
        print(f"# shards={s}: {best:.2f}s warm solve "
              f"({n / best:.0f} spots/s)", file=sys.stderr)

    base = rows[0]["spots_per_sec"]
    for r in rows:
        r["efficiency"] = round(r["spots_per_sec"] / (base * r["n_shards"]), 3)

    meaningful = len({d.process_index for d in devices}) > 1 or (
        jax.default_backend() == "gpu" and len(devices) > 1
    )
    print(json.dumps({
        "metric": "scaling_efficiency",
        "value": rows[-1]["efficiency"],
        "unit": "fraction (spots/s/shard vs 1 shard)",
        "vs_baseline": round(rows[-1]["efficiency"] / 0.8, 3),
        "hardware_parallel": meaningful,
        "rows": rows,
    }))


if __name__ == "__main__":
    main()
