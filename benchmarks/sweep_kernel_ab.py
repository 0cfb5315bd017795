"""Keep-or-drop measurement of the GPU sweep kernel against XLA's sweep.

Builds one problem, prepares it once, and runs the same solve program with
the Pallas sweep kernel (``kernel=True``) and with XLA's sweep
(``kernel=False``) in one process, in turns (kernel, xla, xla, kernel, ...).
Reports, per variant:

* the warm ``solve`` time at the library defaults (tol=1e-4), each timing
  ending in a value fetch of the convergence scalars;
* the per-sweep device time: the device-busy time of a profiler trace of
  one solve at a fixed number of sweeps, divided by that number;
* agreement of the two variants at a fixed number of sweeps.

Needs a GPU; exits non-zero without one. Prints one JSON line per variant
and a last JSON summary line.

    python benchmarks/sweep_kernel_ab.py --graph grid --spots 1000000 --types 20
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def device_busy_seconds(trace_dir: str) -> float:
    """Union of device-op intervals in a profiler trace, in seconds.

    Reads every GPU plane of the ``.xplane.pb`` that ``jax.profiler.trace``
    wrote under ``trace_dir`` and merges the intervals of all its events, so
    overlapping streams are not double counted.
    """
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise RuntimeError(f"no profiler trace under {trace_dir}")
    spans = []
    for plane in ProfileData.from_file(paths[0]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        raise RuntimeError("profiler trace holds no GPU events")
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy * 1e-9


def measure(args, run, jax, tile, tier: str, smi: str) -> None:
    """Interleaved kernel-vs-XLA timings, traces and agreement."""
    variants = {"kernel": True, "xla": False}
    res = {name: {"warm_s": []} for name in variants}
    for name, kernel in variants.items():
        t0 = time.perf_counter()
        run(kernel, 1e-4, 100)
        res[name]["first_call_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        beta, _, _ = run(kernel, 0.0, args.sweeps)
        res[name]["fixed_first_call_s"] = time.perf_counter() - t0
        res[name]["beta_fixed"] = np.asarray(beta)

    for r in range(args.rounds):
        for name in (("kernel", "xla") if r % 2 == 0 else ("xla", "kernel")):
            t0 = time.perf_counter()
            _, n_iter, rel = run(variants[name], 1e-4, 100)
            res[name]["warm_s"].append(time.perf_counter() - t0)
            res[name]["sweeps"] = n_iter

    for name, kernel in variants.items():
        with tempfile.TemporaryDirectory() as d:
            with jax.profiler.trace(d):
                run(kernel, 0.0, args.sweeps)
            res[name]["sweep_device_ms"] = (
                device_busy_seconds(d) / args.sweeps * 1e3
            )

    b_k, b_x = res["kernel"].pop("beta_fixed"), res["xla"].pop("beta_fixed")
    rel_diff = float(np.max(np.abs(b_k - b_x)) / np.max(np.abs(b_x)))
    for name in variants:
        w = res[name]["warm_s"]
        print(json.dumps({
            "variant": name, "tile": list(tile), "graph": args.graph,
            "spots": args.spots, "types": args.types,
            "warm_median_s": float(np.median(w)),
            "warm_s": w, **{k: v for k, v in res[name].items()
                            if k != "warm_s"},
        }), flush=True)
    print(json.dumps({
        "ok": True, "tier": tier, "tile": list(tile), "card": smi,
        "rel_diff_kernel_vs_xla_at_fixed_sweeps": rel_diff,
        "warm_median_s": {n: float(np.median(res[n]["warm_s"]))
                          for n in variants},
        "sweep_device_ms": {n: res[n]["sweep_device_ms"] for n in variants},
        "device_kind": jax.devices()[0].device_kind,
    }), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--graph", choices=("grid", "irregular"), default="grid")
    p.add_argument("--spots", type=int, default=1_000_000)
    p.add_argument("--types", type=int, default=20)
    p.add_argument("--sketch-dim", type=int, default=512)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--sweeps", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiles", default=None,
                   help="comma list of SPOTSxWARPS kernel tilings to measure "
                        "in turn (default: the module's own)")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print(json.dumps({"ok": False, "error": "no GPU visible to JAX"}))
        return 2

    from bench import make_irregular_coords, make_problem
    from flashdeconv_tpu.core.solver import prepare_bcd
    from flashdeconv_tpu.ops import bcd, sweep_kernel
    from flashdeconv_tpu.utils.graph import build_knn_graph

    Y, X, coords = make_problem(args.spots, args.types, args.sketch_dim,
                                seed=args.seed)
    if args.graph == "irregular":
        coords = make_irregular_coords(args.spots, args.seed)
    A = build_knn_graph(coords, k=6)
    prob = prepare_bcd(Y, X, A, coords=coords if args.graph == "grid"
                       else None)
    del Y
    operands = prob._operands()
    static = prob._static()
    dt = prob.dtype
    lam = jnp.asarray(0.1, dt)
    rho = jnp.asarray(0.01 * prob.mean_diag, dt)
    inv_perm = prob._inv_perm_d if prob.perm is not None else None

    def run(kernel: bool, tol: float, max_iter: int):
        out = bcd.solve_program(
            None, operands, inv_perm, lam, rho, jnp.asarray(tol, dt),
            jnp.asarray(max_iter, jnp.int32), max_iter=max_iter,
            kernel=kernel, n_spots=prob.n_spots, **static,
        )
        n_iter, rel = jax.device_get((out[1], out[2]))
        return out[0], int(n_iter), float(rel)

    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(f"# card: {smi}", flush=True)
    tiles = [None] if args.tiles is None else [
        tuple(int(v) for v in t.split("x")) for t in args.tiles.split(",")
    ]
    for tile in tiles:
        if tile is not None:
            # The tiling is read when the kernel is traced: drop every
            # cached trace so the next call builds it anew.
            sweep_kernel._block = lambda n_types, spots=tile[0]: spots
            sweep_kernel._NUM_WARPS = tile[1]
            jax.clear_caches()
        measure(args, run, jax, tile or (sweep_kernel._block(args.types),
                                         sweep_kernel._NUM_WARPS),
                static["tier"], smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
