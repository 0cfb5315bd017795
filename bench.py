"""North-star benchmark: spots/sec on a 1M-spot BCD solve (one GPU).

Mirrors the reference's headline scaling claim (reference ``README.md:63-69``:
1M spots in ~3 min on an M2 Max CPU, i.e. ~5.6k spots/s end-to-end) with the
solve phase — where the reference spends ~all of its wall-clock — timed on one
GPU.

Problem: N = 1,000,000 spots on a 1000x1000 grid (Stereo-seq-like), K = 20
cell types, sketch_dim = 512, kNN(k=6) spatial graph, lambda/rho at library
defaults, solve to tol=1e-4.

The problem is prepared once (`prepare_bcd`: host precompute + one-time
device upload — the analog of the reference driver's per-solve precomputation
at reference ``flashdeconv/core/solver.py:346-347``) and the timed region is
the warm `BCDProblem.solve` call: the on-device solve program plus the
convergence/objective scalar fetch, with beta left on device
(`return_device=True`); beta is fetched and validated once outside it.
Prepare and fetch times are reported on stderr.

Without a GPU it prints one JSON error line and exits non-zero. Otherwise it
prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} naming
the platform, device kind and count, and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# Reference baseline: 1M spots in ~180 s (README.md:67) => ~5,556 spots/s.
_BASELINE_SPOTS_PER_SEC = 1_000_000 / 180.0

# Headline shape is 1M spots x 20 types; FLASHDECONV_BENCH_SPOTS /
# FLASHDECONV_BENCH_TYPES override for scaling-headroom runs (e.g. 10M
# spots, or K=160 to exercise the XLA large-K tier).
N_SPOTS = int(os.environ.get("FLASHDECONV_BENCH_SPOTS", 1_000_000))
N_TYPES = int(os.environ.get("FLASHDECONV_BENCH_TYPES", 20))
SKETCH_DIM = 512
K_NEIGHBORS = 6
MAX_ITER = 100
TOL = 1e-4


def make_problem(n_spots: int, n_types: int, d: int, seed: int = 0):
    """Synthetic sketch-space problem with spatially smooth ground truth."""
    from flashdeconv_tpu.utils.graph import grid_coords

    rng = np.random.default_rng(seed)  # PCG64: fast f32 draws at 1M x 512
    side = int(np.ceil(np.sqrt(n_spots)))
    coords = grid_coords(n_spots)

    X_sketch = rng.standard_normal((n_types, d), dtype=np.float32)

    # Smooth ground-truth abundances: soft assignment to K spatial centers.
    centers = rng.random((n_types, 2)) * side
    beta_true = np.empty((n_spots, n_types), dtype=np.float32)
    scale = 2.0 * (0.25 * side) ** 2
    for k in range(n_types):  # per-type pass keeps peak memory O(N)
        d2 = ((coords - centers[k]) ** 2).sum(axis=1)
        beta_true[:, k] = np.exp(-d2 / scale)
    beta_true /= beta_true.sum(axis=1, keepdims=True)

    Y_sketch = beta_true @ X_sketch
    # Chunked noise add: PCG64 draws are sequential, so per-block
    # standard_normal calls produce the exact same stream as one giant
    # call — but the temporary stays ~256 MB instead of a second full
    # (N, d) array, which matters on hosts that fault fresh anonymous
    # pages slowly (20 GB of extra first-touch at 10M spots).
    step = 1 << 17
    for s in range(0, n_spots, step):
        e = min(n_spots, s + step)
        noise = rng.standard_normal((e - s, d), dtype=np.float32)
        noise *= 0.05
        Y_sketch[s:e] += noise
    return Y_sketch, X_sketch, coords


def make_irregular_coords(n_spots: int, seed: int = 0) -> np.ndarray:
    """Jittered lattice positions in random order (bead-array-like): the
    kNN graph is banded in no row order, so a solve takes the gather tier."""
    from flashdeconv_tpu.utils.graph import grid_coords

    rng = np.random.default_rng(seed + 1)
    coords = grid_coords(n_spots) + rng.uniform(-0.45, 0.45, (n_spots, 2))
    return coords[rng.permutation(n_spots)]


def mesh_bench(problem, Y_sketch, X_sketch, A, coords, n, solve_kwargs,
               warm_ref, info_ref) -> None:
    """``--mesh`` mode: the GSPMD sharded solve on a mesh of every visible
    device, checked against the single-device solve. Prints its own JSON
    line with the on-device parity vs the single-device beta.
    """
    from flashdeconv_tpu.parallel.solver import prepare_sharded_bcd

    t0 = time.perf_counter()
    sp = prepare_sharded_bcd(
        Y_sketch, X_sketch, A, coords=coords, strategy="banded"
    )
    prepare_s = time.perf_counter() - t0
    print(
        f"# mesh prepare {prepare_s:.2f}s  strategy={sp.strategy}",
        file=sys.stderr,
    )

    t0 = time.perf_counter()
    beta_d, info = sp.solve(return_device=True, **solve_kwargs)
    print(f"# mesh cold solve {time.perf_counter() - t0:.2f}s, "
          f"{info['n_iterations']} sweeps", file=sys.stderr)

    warm = float("inf")
    for i in range(5):
        t0 = time.perf_counter()
        beta_d, info = sp.solve(return_device=True, **solve_kwargs)
        dt = time.perf_counter() - t0
        warm = min(warm, dt)
        print(
            f"# mesh warm solve[{i}] {dt:.3f}s, "
            f"{info['n_iterations']} sweeps, converged={info['converged']}",
            file=sys.stderr,
        )

    # Parity vs the single-device solve: identical sweep count and
    # f32-rounding-level beta agreement. Fetch both to host before
    # subtracting — an eager op between a mesh-sharded array and a
    # single-device-committed one raises "incompatible devices" the
    # moment the mesh spans more than one chip.
    beta_ref_d, _ = problem.solve(return_device=True, **solve_kwargs)
    maxdiff = float(
        np.max(np.abs(np.asarray(beta_d) - np.asarray(beta_ref_d)))
    )
    assert info["n_iterations"] == info_ref["n_iterations"]
    assert maxdiff < 1e-5, maxdiff
    assert info["converged"]

    spots_per_sec = n / warm
    print(
        json.dumps(
            {
                "metric": f"spots_per_sec_bcd_solve_{n}spots_gspmd_mesh",
                "value": round(spots_per_sec, 1),
                "unit": "spots/s",
                "vs_baseline": round(spots_per_sec / _BASELINE_SPOTS_PER_SEC, 2),
                "warm_solve_seconds": round(warm, 3),
                "warm_single_device_seconds": round(warm_ref, 3),
                "mesh_devices": info["n_shards"],
                "sweep_kernel": info.get("sweep_kernel"),
                "n_iterations": info["n_iterations"],
                "max_abs_diff_vs_single_device": maxdiff,
            }
        )
    )


def device_header() -> dict:
    """Platform, device kind and count, and the card's name and power
    limit as nvidia-smi reports them."""
    import subprocess

    import jax

    dev = jax.devices()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=False,
        ).stdout.strip().splitlines()
    except OSError:
        smi = []
    return {
        "platform": dev[0].platform,
        "device_kind": dev[0].device_kind,
        "device_count": len(dev),
        "card": smi[0] if smi else None,
    }


def main() -> int:
    import jax

    from flashdeconv_tpu.core.solver import prepare_bcd
    from flashdeconv_tpu.utils.graph import build_knn_graph

    mesh_mode = "--mesh" in sys.argv[1:]

    if jax.devices()[0].platform != "gpu":
        print(json.dumps({
            "error": "no GPU visible to JAX",
            "platform": jax.devices()[0].platform,
        }))
        return 1
    header = device_header()
    print(f"# {header}", file=sys.stderr)
    n = N_SPOTS

    from flashdeconv_tpu.utils.hostmem import reserve_host_arena_async

    # Arena pre-fault in the background, sized to the problem (~10 GB at
    # the 1M headline): problem generation + graph build run concurrently
    # with the faulting, and only prepare waits for it.
    t_arena = time.perf_counter()
    arena = reserve_host_arena_async(min(10.0, max(0.5, 10.0 * n / 1e6)))
    print(f"# generating {n}-spot problem...", file=sys.stderr)
    Y_sketch, X_sketch, coords = make_problem(n, N_TYPES, SKETCH_DIM)

    print("# building kNN graph...", file=sys.stderr)
    t0 = time.perf_counter()
    A = build_knn_graph(coords, k=K_NEIGHBORS)
    print(f"# graph built in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    if arena.wait():
        print(
            f"# host arena ready {time.perf_counter() - t_arena:.1f}s after "
            f"start; blocked {time.perf_counter() - t0:.1f}s (rest "
            "overlapped with generation + graph)",
            file=sys.stderr,
        )

    solve_kwargs = dict(lambda_=0.1, rho=0.01, max_iter=MAX_ITER, tol=TOL)

    # One-time prepare: host precompute (Xty/Gram/YtY matmuls, banded graph
    # decomposition) + device upload.
    t0 = time.perf_counter()
    problem = prepare_bcd(Y_sketch, X_sketch, A, coords=coords)
    prepare_s = time.perf_counter() - t0
    print(f"# prepare (host precompute + upload) {prepare_s:.2f}s",
          file=sys.stderr)

    # Cold run: compile + execute.
    t0 = time.perf_counter()
    beta_d, info = problem.solve(return_device=True, **solve_kwargs)
    cold = time.perf_counter() - t0
    print(
        f"# cold solve {cold:.2f}s, {info['n_iterations']} sweeps, "
        f"converged={info['converged']}",
        file=sys.stderr,
    )

    # Warm runs (compile cached, operands resident): report the best of 8.
    # solve() returns only after the convergence + objective scalars are
    # fetched, so each timing covers the complete solve.
    warm = float("inf")
    for i in range(8):
        t0 = time.perf_counter()
        beta_d, info = problem.solve(return_device=True, **solve_kwargs)
        dt = time.perf_counter() - t0
        warm = min(warm, dt)
        print(
            f"# warm solve[{i}] {dt:.3f}s, {info['n_iterations']} sweeps, "
            f"converged={info['converged']}",
            file=sys.stderr,
        )

    if mesh_mode:
        # --mesh: skip the single-device JSON + fetch; benchmark the GSPMD
        # sharded executable on real hardware instead, using the resident
        # single-device problem only as the parity oracle.
        mesh_bench(problem, Y_sketch, X_sketch, A, coords, n, solve_kwargs,
                   warm, info)
        return 0

    t0 = time.perf_counter()
    beta = np.asarray(beta_d)
    print(f"# result fetch ({beta.nbytes / 1e6:.0f} MB) "
          f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
    assert np.all(beta >= 0) and np.all(np.isfinite(beta))
    assert info["converged"]

    spots_per_sec = n / warm
    print(
        json.dumps(
            {
                "metric": f"spots_per_sec_bcd_solve_{n}spots_1gpu",
                "value": round(spots_per_sec, 1),
                "unit": "spots/s",
                "vs_baseline": round(spots_per_sec / _BASELINE_SPOTS_PER_SEC, 2),
                "warm_solve_seconds": round(warm, 3),
                "prepare_seconds": round(prepare_s, 2),
                "n_iterations": info["n_iterations"],
                "sweep_kernel": info["sweep_kernel"],
                **header,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
