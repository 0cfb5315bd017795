#!/usr/bin/env python3
"""Smoke run of the deconvolution solver on one NVIDIA GPU.

Drives the main path through the public entry points (``prepare_bcd`` +
``BCDProblem.solve``, and ``FlashDeconv.fit``) at real sizes, with data made
from ``--seed``, and checks each result on the card:

* ``grid``      — 1M-bin kNN-6 grid, K=20, d=512 (Stereo-seq bin20 on a
  1 cm^2 chip): float32 against float64 at 20 fixed sweeps, the default
  solve converges, and (when the GPU sweep kernel runs) the kernel against
  XLA's banded sweep at 20 fixed sweeps;
* ``pipeline``  — ``FlashDeconv(sketch_dim=512).fit`` from sparse CSR counts,
  406^2 = 164,836 bins (Visium HD at 16 um) x 18k genes, ~97% sparse: rows
  sum to 1, Pearson against the true proportions, float32 against a
  float64 fit;
* ``irregular`` — 1M jittered, shuffled positions, kNN-6 (the gather tier):
  float32 against float64 at 20 fixed sweeps;
* ``largek``    — 512^2 = 262,144-bin grid at K=128: float32 against
  float64 at 20 fixed sweeps, with the compile time.

Tolerances: float32 against float64 at 20 sweeps is held to 1e-4 of
max|beta64| (float32 rounding, ~6e-8 per operation, accumulated over 20
contracting sweeps); the kernel against XLA's float32 sweep to 1e-5 (the same
float32 arithmetic in another summation order). Every product is true FP32
(``precision=HIGHEST``), never TF32. Pipeline proportions against the
float64 fit: 1e-3 absolute.

``--four-cards`` runs only the multi-card path: a 3250^2 = 10.6M-bin grid
(Visium HD at 2 um), K=20, built through ``xty=``/``yty=`` (no sketch on the
host), solved by ``prepare_sharded_bcd`` with ``strategy="banded"`` (GSPMD)
and ``strategy="halo"`` on a 4-card mesh against the single-card solve at 20
fixed sweeps (1e-5 of max|beta|), plus each strategy's warm solve time.

One process drives the card(s). Without a GPU the script exits non-zero and
prints no result. The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

    python chip_smoke.py [--seed 0] [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))


def _peak_bytes() -> int:
    import jax

    return max(
        int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
        for d in jax.local_devices()
    )


def _card() -> str:
    """The cards' name and power limit, as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=False,
        ).stdout.strip()
    except OSError as e:
        return f"nvidia-smi unavailable ({e})"


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


class Phase:
    """Collects one phase's timings and checks; prints them as one line."""

    def __init__(self, name: str):
        self.name = name
        self.record: dict = {"phase": name}
        self.checks: list = []

    def check(self, name: str, value: float, limit: float,
              below: bool = True) -> None:
        ok = bool(value <= limit) if below else bool(value > limit)
        self.checks.append({"check": name, "value": value,
                            "limit": ("<= " if below else "> ") + str(limit),
                            "ok": ok})

    @property
    def ok(self) -> bool:
        return bool(self.checks) and all(c["ok"] for c in self.checks)

    def emit(self) -> None:
        self.record["checks"] = self.checks
        self.record["peak_device_bytes"] = _peak_bytes()
        self.record["ok"] = self.ok
        print(json.dumps(self.record), flush=True)


def _timed_solves(ph: Phase, prob) -> None:
    """Cold and warm default solves; records compile/warm seconds, sweeps,
    the engaged sweep kernel, and checks convergence."""
    t0 = time.perf_counter()
    prob.solve(return_device=True)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, info = prob.solve(return_device=True)
    warm = time.perf_counter() - t0
    ph.record.update(compile_s=cold - warm, warm_s=warm,
                     sweeps=info["n_iterations"],
                     sweep_kernel=info["sweep_kernel"])
    ph.check("default_solve_converged", float(info["converged"]), 0.5,
             below=False)


def _f32_vs_f64(ph: Phase, p32, p64, sweeps: int = 20) -> np.ndarray:
    b32, _ = p32.solve(max_iter=sweeps, tol=0.0)
    b64, _ = p64.solve(max_iter=sweeps, tol=0.0)
    ph.check(f"f32_vs_f64_{sweeps}sweeps_rel", _rel(b32, b64), 1e-4)
    return b32


def phase_grid(seed: int) -> Phase:
    import jax.numpy as jnp

    from bench import make_problem
    from flashdeconv_tpu.core.solver import prepare_bcd
    from flashdeconv_tpu.ops import bcd
    from flashdeconv_tpu.utils.graph import build_knn_graph

    ph = Phase("grid")
    Y, X, coords = make_problem(1_000_000, 20, 512, seed=seed)
    A = build_knn_graph(coords, k=6)
    t0 = time.perf_counter()
    p32 = prepare_bcd(Y, X, A, coords=coords)
    ph.record["prepare_s"] = time.perf_counter() - t0
    _timed_solves(ph, p32)
    p64 = prepare_bcd(Y, X, A, dtype=np.float64, coords=coords)
    del Y
    b32 = _f32_vs_f64(ph, p32, p64)
    del p64
    if p32.sweep_kernel != "xla":
        # The same 20 sweeps through XLA's banded sweep.
        inv = p32._inv_perm_d if p32.perm is not None else None
        bx = bcd.solve_program(
            None, p32._operands(), inv, jnp.float32(0.1),
            jnp.float32(0.01 * p32.mean_diag), jnp.float32(0.0),
            jnp.asarray(20, jnp.int32), max_iter=20, kernel=False,
            n_spots=p32.n_spots, **p32._static(),
        )[0]
        ph.check("kernel_vs_xla_20sweeps_rel", _rel(b32, bx), 1e-5)
    return ph


def phase_pipeline(seed: int) -> Phase:
    from atlas_e2e import make_mixture_counts
    from flashdeconv_tpu import FlashDeconv
    from flashdeconv_tpu.utils.metrics import compute_correlation

    ph = Phase("pipeline")
    t0 = time.perf_counter()
    Y, X, coords, truth = make_mixture_counts(406 * 406, 18_000, 700, 20,
                                              seed=seed)
    ph.record.update(generate_s=time.perf_counter() - t0,
                     spots=Y.shape[0], genes=Y.shape[1],
                     sparsity=1.0 - Y.nnz / (Y.shape[0] * Y.shape[1]))
    t0 = time.perf_counter()
    FlashDeconv(sketch_dim=512).fit(Y, X, coords)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    m32 = FlashDeconv(sketch_dim=512).fit(Y, X, coords)
    warm = time.perf_counter() - t0
    P32 = m32.proportions_
    ph.record.update(compile_s=cold - warm, warm_fit_s=warm,
                     sweeps=m32.info_["n_iterations"],
                     sweep_kernel=m32.info_.get("sweep_kernel"),
                     stages_s=m32.timings_)
    m64 = FlashDeconv(sketch_dim=512, solver_dtype=np.float64).fit(
        Y, X, coords
    )
    ph.check("row_sum_max_abs_err",
             float(np.max(np.abs(P32.sum(axis=1) - 1.0))), 1e-5)
    ph.check("pearson_vs_truth", compute_correlation(P32, truth), 0.9,
             below=False)
    ph.check("props_f32_vs_f64_max_abs",
             float(np.max(np.abs(P32 - m64.proportions_))), 1e-3)
    return ph


def phase_irregular(seed: int) -> Phase:
    from bench import make_irregular_coords, make_problem
    from flashdeconv_tpu.core.solver import prepare_bcd
    from flashdeconv_tpu.utils.graph import build_knn_graph

    ph = Phase("irregular")
    Y, X, _ = make_problem(1_000_000, 20, 512, seed=seed)
    coords = make_irregular_coords(1_000_000, seed=seed)
    A = build_knn_graph(coords, k=6)
    p32 = prepare_bcd(Y, X, A)
    ph.record["tier"] = "banded" if p32.use_banded else "gather"
    ph.check("gather_tier", float(p32.use_banded), 0.5)
    _timed_solves(ph, p32)
    p64 = prepare_bcd(Y, X, A, dtype=np.float64)
    _f32_vs_f64(ph, p32, p64)
    return ph


def phase_largek(seed: int) -> Phase:
    from bench import make_problem
    from flashdeconv_tpu.core.solver import prepare_bcd
    from flashdeconv_tpu.utils.graph import build_knn_graph

    ph = Phase("largek")
    Y, X, coords = make_problem(512 * 512, 128, 512, seed=seed)
    A = build_knn_graph(coords, k=6)
    p32 = prepare_bcd(Y, X, A, coords=coords)
    _timed_solves(ph, p32)
    p64 = prepare_bcd(Y, X, A, dtype=np.float64, coords=coords)
    _f32_vs_f64(ph, p32, p64)
    return ph


def _grid_xty(n_spots: int, n_types: int, d: int, seed: int):
    """Sketch-free grid problem: ``Xty = Y_sketch @ X_sketch.T`` and
    ``YtY = ||Y_sketch||^2`` drawn directly from the distribution that
    ``bench.make_problem`` would give them (smooth abundances plus Gaussian
    sketch noise of scale 0.05), so no (N, d) sketch is ever built."""
    from flashdeconv_tpu.utils.graph import grid_coords

    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_spots)))
    coords = grid_coords(n_spots)
    X = rng.standard_normal((n_types, d), dtype=np.float32)
    G = X.astype(np.float64) @ X.T.astype(np.float64)
    centers = rng.random((n_types, 2)) * side
    beta = np.empty((n_spots, n_types), dtype=np.float32)
    scale = 2.0 * (0.25 * side) ** 2
    for k in range(n_types):
        beta[:, k] = np.exp(-((coords - centers[k]) ** 2).sum(axis=1) / scale)
    beta /= beta.sum(axis=1, keepdims=True)
    # noise @ X.T has covariance 0.05^2 * G: draw it through G's Cholesky.
    L = np.linalg.cholesky(G).astype(np.float32)
    xty = beta @ G.astype(np.float32)
    xty += 0.05 * rng.standard_normal((n_spots, n_types),
                                      dtype=np.float32) @ L.T
    yty = float(np.sum((beta.T.astype(np.float64) @ beta) * G)
                + n_spots * d * 0.05 ** 2)
    return X, xty, yty, coords


def phase_four_cards(seed: int) -> Phase:
    import jax
    from jax.sharding import Mesh

    from flashdeconv_tpu.core.solver import prepare_bcd
    from flashdeconv_tpu.parallel.solver import prepare_sharded_bcd
    from flashdeconv_tpu.utils.graph import build_knn_graph

    ph = Phase("four_cards")
    n = 3250 * 3250
    t0 = time.perf_counter()
    X, xty, yty, coords = _grid_xty(n, 20, 512, seed)
    A = build_knn_graph(coords, k=6)
    ph.record.update(spots=n, generate_s=time.perf_counter() - t0)
    fixed = dict(max_iter=20, tol=0.0)

    single = prepare_bcd(None, X, A, coords=coords, xty=xty, yty=yty)
    ref, info1 = single.solve(**fixed)
    ph.record["single_sweep_kernel"] = info1["sweep_kernel"]
    single.solve(return_device=True)
    t0 = time.perf_counter()
    single.solve(return_device=True)
    ph.record["single_warm_s"] = time.perf_counter() - t0
    del single

    mesh = Mesh(np.asarray(jax.devices()[:4]), ("spots",))
    for strategy in ("banded", "halo"):
        t0 = time.perf_counter()
        sp = prepare_sharded_bcd(None, X, A, coords=coords, mesh=mesh,
                                 strategy=strategy, xty=xty, yty=yty)
        ph.record[f"{strategy}_prepare_s"] = time.perf_counter() - t0
        beta, _ = sp.solve(**fixed)
        ph.check(f"{strategy}_vs_single_20sweeps_rel", _rel(beta, ref), 1e-5)
        sp.solve(return_device=True)
        t0 = time.perf_counter()
        _, info = sp.solve(return_device=True)
        ph.record[f"{strategy}_warm_s"] = time.perf_counter() - t0
        ph.record[f"{strategy}_sweeps"] = info["n_iterations"]
        del sp
    return ph


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card sharded path and its check")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU visible to JAX (found "
              f"{devices[0].platform}); nothing run", file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    sys.path[:0] = [_ROOT, os.path.join(_ROOT, "benchmarks")]
    try:
        import flashdeconv_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the flashdeconv_tpu package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)  # the float64 references

    smi = _card()
    print(f"# card: {smi}", flush=True)

    phases = ([phase_four_cards] if args.four_cards else
              [phase_grid, phase_pipeline, phase_irregular, phase_largek])
    all_ok = True
    for fn in phases:
        t0 = time.perf_counter()
        try:
            ph = fn(args.seed)
        except Exception:
            traceback.print_exc()
            ph = Phase(fn.__name__[len("phase_"):])
            ph.record["error"] = traceback.format_exc().splitlines()[-1]
        ph.record["phase_s"] = time.perf_counter() - t0
        ph.emit()
        all_ok &= ph.ok

    print(f"# card: {smi}", flush=True)
    if not all_ok:
        print(json.dumps({"ok": False}))
        return 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind,
                   "count": len(devices)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
