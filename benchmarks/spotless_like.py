"""Spotless-style silver-standard accuracy harness.

The Spotless benchmark (Sang-aram et al. 2024) evaluates deconvolution on
*silver standards*: synthetic spots composed by pooling **individual real
scRNA-seq cells** with known per-spot cell-type counts, deconvolved against
a reference built from *held-out* cells of the same dataset. The real
56-dataset suite needs external downloads (zero network egress here — see
``docs/real_data_validation.md``); this harness reproduces the **protocol**
offline so accuracy can be tracked against the reference implementation's
published mean Pearson of 0.944 (reference ``README.md:73-78``).

Protocol per dataset (mirrors the silver-standard generation):

1. Simulate an scRNA-seq dataset: per-type expression programs with
   exclusive markers, per-cell library-size variation (lognormal), and
   per-cell/per-gene overdispersion (gamma multiplicative noise -> NB-like
   marginals), Poisson-sampled counts per cell.
2. Split cells 50/50 into a *generation* pool and a *reference* pool.
3. Compose spots by sampling 2-12 generation cells per spot (spatially
   structured type frequencies) and **summing their UMI counts**; ground
   truth is the cell-count proportion per spot.
4. Build the signature matrix from the reference pool only (per-type mean,
   the ``io.load_reference`` aggregation) — the model never sees the
   generating cells.
5. Deconvolve with default settings; score Pearson r between predicted and
   true proportions over all spots x types, plus JSD and rare-type F1.

The suite is 7 named designs x `--replicates` seeds (28 datasets by
default; `--quick` runs one replicate of each design).

Usage: python benchmarks/spotless_like.py [--quick] [--replicates 4]
       [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from flashdeconv_tpu.utils.graph import grid_coords


def simulate_cells(n_types, n_genes, cells_per_type, rng,
                   markers_per_type=25, bcv=0.35):
    """Simulate an scRNA-seq count matrix with type labels.

    Returns (counts (n_cells, n_genes) float64, labels (n_cells,) int).
    """
    # Per-type programs: sparse gamma loadings + exclusive markers.
    programs = rng.gamma(2.0, 1.0, size=(n_types, n_genes))
    programs *= rng.rand(n_types, n_genes) < 0.25
    for k in range(n_types):
        cols = rng.choice(n_genes, size=markers_per_type, replace=False)
        programs[:, cols] = 0.0
        programs[k, cols] = rng.gamma(6.0, 2.0, size=markers_per_type)
    programs /= programs.sum(axis=1, keepdims=True) + 1e-12

    n_cells = n_types * cells_per_type
    labels = np.repeat(np.arange(n_types), cells_per_type)
    # Per-cell library size (lognormal) and per-cell/per-gene biological
    # overdispersion (gamma with unit mean -> NB-like counts).
    lib = rng.lognormal(np.log(3000.0), 0.35, size=(n_cells, 1))
    shape = 1.0 / (bcv * bcv)
    noise = rng.gamma(shape, 1.0 / shape, size=(n_cells, n_genes))
    mean = lib * programs[labels] * noise
    counts = rng.poisson(mean).astype(np.float64)
    order = rng.permutation(n_cells)
    return counts[order], labels[order]


def compose_spots(counts, labels, n_types, n_spots, rng,
                  cells_per_spot=(2, 12), pattern="regional",
                  type_freq=None, target_depth=None):
    """Pool generation cells into spots (the silver-standard composition).

    Returns (Y (n_spots, n_genes), coords, truth proportions (cell-count
    fractions per spot)).
    """
    side = int(np.ceil(np.sqrt(n_spots)))
    coords = grid_coords(n_spots)

    if type_freq is None:
        type_freq = np.ones(n_types) / n_types
    if pattern == "regional":
        centers = rng.rand(n_types, 2) * side
        d2 = ((coords[:, None] - centers[None]) ** 2).sum(-1)
        base = np.exp(-d2 / (2 * (0.3 * side) ** 2)) * type_freq
    else:  # "uniform"
        base = np.broadcast_to(type_freq, (n_spots, n_types)).copy()

    by_type = [np.flatnonzero(labels == k) for k in range(n_types)]
    Y = np.zeros((n_spots, counts.shape[1]))
    props = np.zeros((n_spots, n_types))
    lo, hi = cells_per_spot
    for i in range(n_spots):
        n_cells_i = int(rng.randint(lo, hi + 1))
        p = base[i] / base[i].sum()
        types_i = rng.choice(n_types, size=n_cells_i, p=p)
        for k in types_i:
            j = by_type[k][rng.randint(len(by_type[k]))]
            Y[i] += counts[j]
        binc = np.bincount(types_i, minlength=n_types)
        props[i] = binc / n_cells_i

    if target_depth is not None:
        # Binomial downsampling to the platform's depth regime.
        depth = Y.sum(axis=1, keepdims=True)
        keep = np.minimum(target_depth / np.maximum(depth, 1.0), 1.0)
        Y = rng.binomial(Y.astype(np.int64), keep).astype(np.float64)
    return Y, coords, props


def reference_from_cells(counts, labels, n_types):
    """Per-type mean signature from the held-out pool (K x G)."""
    X = np.zeros((n_types, counts.shape[1]))
    for k in range(n_types):
        members = labels == k
        X[k] = counts[members].mean(axis=0) if members.any() else 0.0
    return X


# Named designs, echoing the Spotless suite's artificial_* regimes.
DESIGNS = {
    "regional_deep": dict(n_types=10, pattern="regional"),
    "regional_shallow": dict(n_types=10, pattern="regional",
                             target_depth=800),
    "uniform_mix": dict(n_types=10, pattern="uniform"),
    "rare_type": dict(n_types=10, pattern="regional", rare_frac=0.03),
    "dominant_type": dict(n_types=10, pattern="regional",
                          dominant_frac=0.6),
    "many_types": dict(n_types=20, pattern="regional"),
    "few_cells": dict(n_types=10, pattern="regional",
                      cells_per_spot=(2, 4)),
}


def design_type_freq(n_types, rare_frac=None, dominant_frac=None):
    """Per-type sampling frequencies for a design: uniform, or type 0
    forced rare/dominant — ONE home shared with benchmarks/sensitivity.py
    so the rare/dominant regimes cannot silently diverge between the
    accuracy and sensitivity harnesses."""
    type_freq = np.ones(n_types) / n_types
    if rare_frac is not None:
        type_freq = np.full(n_types, (1 - rare_frac) / (n_types - 1))
        type_freq[0] = rare_frac
    if dominant_frac is not None:
        type_freq = np.full(n_types, (1 - dominant_frac) / (n_types - 1))
        type_freq[0] = dominant_frac
    return type_freq


def _reference_model_cls():
    """The reference implementation's FlashDeconv (numba stubbed to pure
    Python), for same-data head-to-head accuracy comparison."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
    from reference_harness import import_reference

    return import_reference().FlashDeconv


def run_dataset(design_name, seed, n_spots=600, n_genes=5000,
                cells_per_type=120, engine="jax"):
    """Generate one silver-standard dataset and deconvolve it."""
    if engine == "reference":
        FlashDeconv = _reference_model_cls()
    else:
        from flashdeconv_tpu import FlashDeconv
    from flashdeconv_tpu.utils.metrics import compute_correlation, compute_jsd

    cfg = dict(DESIGNS[design_name])
    n_types = cfg.pop("n_types")
    pattern = cfg.pop("pattern")
    target_depth = cfg.pop("target_depth", None)
    cells_per_spot = cfg.pop("cells_per_spot", (2, 12))
    rare_frac = cfg.pop("rare_frac", None)
    dominant_frac = cfg.pop("dominant_frac", None)

    rng = np.random.RandomState(seed)
    counts, labels = simulate_cells(n_types, n_genes, cells_per_type, rng)

    # 50/50 generation / reference split: the model's signature matrix is
    # estimated from cells it never deconvolves.
    half = counts.shape[0] // 2
    gen_counts, gen_labels = counts[:half], labels[:half]
    ref_counts, ref_labels = counts[half:], labels[half:]

    type_freq = design_type_freq(n_types, rare_frac, dominant_frac)

    Y, coords, props = compose_spots(
        gen_counts, gen_labels, n_types, n_spots, rng,
        cells_per_spot=cells_per_spot, pattern=pattern,
        type_freq=type_freq, target_depth=target_depth,
    )
    X = reference_from_cells(ref_counts, ref_labels, n_types)

    t0 = time.perf_counter()
    model = FlashDeconv(
        sketch_dim=512, lambda_spatial="auto", n_hvg=2000,
        n_markers_per_type=50, random_state=0,
    )
    pred = model.fit_transform(Y, X, coords)
    secs = time.perf_counter() - t0

    r = float(compute_correlation(pred, props, "pearson"))
    jsd = float(np.mean(compute_jsd(pred, props)))
    row = {
        "design": design_name, "seed": seed, "pearson": round(r, 4),
        "jsd": round(jsd, 4), "seconds": round(secs, 2),
        "n_types": n_types,
    }
    if rare_frac is not None:
        # Cell-count truths are quantized at 1/cells_per_spot, so the
        # sub-threshold F1 is undefined; score the rare type (index 0)
        # directly: its own Pearson and presence detection at half its
        # smallest possible nonzero abundance.
        r_rare = float(
            compute_correlation(pred[:, :1], props[:, :1], "pearson")
        )
        thr = 0.5 / cells_per_spot[1]
        present_true = props[:, 0] > 0
        present_pred = pred[:, 0] > thr
        tp = float(np.sum(present_pred & present_true))
        prec = tp / max(np.sum(present_pred), 1)
        rec = tp / max(np.sum(present_true), 1)
        row["rare_type_pearson"] = round(r_rare, 4)
        row["rare_f1"] = round(
            2 * prec * rec / max(prec + rec, 1e-10), 4
        )
    return row


def run(quick=False, replicates=4, seed0=0, engine="jax"):
    names = list(DESIGNS)
    reps = 1 if quick else replicates
    results = []
    total = len(names) * reps
    for rep in range(reps):
        for j, name in enumerate(names):
            row = run_dataset(name, seed=seed0 + 97 * rep + j, engine=engine)
            results.append(row)
            print(
                f"# [{len(results)}/{total}] {name} rep={rep}: "
                f"r={row['pearson']:.3f} jsd={row['jsd']:.3f} "
                f"({row['seconds']:.1f}s)",
                file=sys.stderr,
            )

    rs = [x["pearson"] for x in results]
    import subprocess

    import jax

    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=False,
        ).stdout.strip() or None
    except OSError:
        card = None
    return {
        "metric": "spotless_like_mean_pearson"
                  + ("_reference_impl" if engine == "reference" else ""),
        "engine": engine,
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind, "card": card},
        "value": round(float(np.mean(rs)), 4),
        "unit": "pearson_r",
        "vs_baseline": round(float(np.mean(rs)) / 0.944, 3),
        "min_pearson": round(float(np.min(rs)), 4),
        "n_datasets": len(results),
        "protocol": "silver-standard: spots pooled from simulated cells, "
                    "reference from held-out cells",
        "datasets": results,
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--replicates", type=int, default=4)
    ap.add_argument("--engine", choices=("jax", "reference"), default="jax",
                    help="'reference' runs the original implementation "
                         "(numba stubbed to pure Python) on the SAME "
                         "datasets for a head-to-head accuracy comparison")
    ap.add_argument("--out", type=str, default=None,
                    help="also write full per-dataset JSON to this path")
    args = ap.parse_args()
    out = run(quick=args.quick, replicates=args.replicates,
              engine=args.engine)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
    print(json.dumps({k: v for k, v in out.items() if k != "datasets"}))
