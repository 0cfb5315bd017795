"""Spotless REAL-suite runner — one command from data to the 0.944 comparison.

The reference's headline accuracy claim is a mean Pearson of **0.944** over
the 56 Spotless silver-standard datasets (reference ``README.md:73-78``;
Sang-aram et al. 2024, Zenodo record 10277187). This container has zero
network egress (see ``docs/real_data_validation.md``), so the suite cannot
be downloaded here — this script is the READY runner: on any networked
machine, download + convert once, then

    python benchmarks/spotless_real.py --data /path/to/spotless_converted

emits the same JSON schema as ``benchmarks/spotless_like.py`` (the offline
protocol replica), so the two numbers are directly comparable and the
published 0.944 is one command away.

Expected layout (one directory per dataset; names become dataset ids)::

    <data_dir>/<dataset>/
        spots.npz              scipy.sparse.save_npz CSR, (n_spots, n_genes)
                               raw synthspot UMI counts
        genes.txt              one gene symbol per line (spots' columns)
        truth.csv              ground-truth proportions: header row = cell
                               type names, one row per spot
        reference.npz          CSR (n_cells, n_genes) held-out scRNA-seq
                               counts (same gene order as genes.txt, or
                               provide reference_genes.txt to align)
        reference_labels.txt   one cell-type label per reference cell
        coords.csv             OPTIONAL x,y per spot; synthspot datasets
                               have no geometry, so the default is the
                               row-major unit grid the reference
                               implementation also falls back to
        reference_genes.txt    OPTIONAL (when the reference matrix has its
                               own gene order/universe)

Converting the Zenodo bundles (R, one-time, on the networked machine)::

    # for each silver-standard .rds (synthspot output) + matched reference:
    #   writeMM / write the counts to .mtx, the composition matrix to csv,
    #   labels + genes to text; then in Python:
    #   scipy.io.mmread(...).tocsr() -> sparse.save_npz("spots.npz", Y)

Datasets whose directories are missing files are reported and skipped, so a
partial download still produces a (labeled) partial mean.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time

import numpy as np
from scipy import sparse

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REQUIRED = ("spots.npz", "genes.txt", "truth.csv", "reference.npz",
            "reference_labels.txt")


def _read_lines(path):
    with open(path) as fh:
        return np.array([ln.strip() for ln in fh if ln.strip()])


def _read_truth(path):
    with open(path) as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = [[float(v) for v in row] for row in reader]
    return np.array(header), np.asarray(rows, dtype=np.float64)


def load_dataset(ddir):
    """Load one converted Spotless dataset directory."""
    Y = sparse.load_npz(os.path.join(ddir, "spots.npz")).tocsr()
    genes = _read_lines(os.path.join(ddir, "genes.txt"))
    type_names, truth = _read_truth(os.path.join(ddir, "truth.csv"))
    ref = sparse.load_npz(os.path.join(ddir, "reference.npz")).tocsr()
    labels = _read_lines(os.path.join(ddir, "reference_labels.txt"))

    rg_path = os.path.join(ddir, "reference_genes.txt")
    ref_genes = _read_lines(rg_path) if os.path.exists(rg_path) else genes

    coords_path = os.path.join(ddir, "coords.csv")
    if os.path.exists(coords_path):
        coords = np.loadtxt(coords_path, delimiter=",", ndmin=2)
    else:
        # synthspot datasets carry no geometry: the row-major unit grid is
        # the same fallback the scanpy-style API uses for coordinate-less
        # AnnData (io/loader.py load_spatial_data).
        side = int(np.ceil(np.sqrt(Y.shape[0])))
        xs, ys = np.meshgrid(np.arange(side), np.arange(side))
        coords = np.column_stack([xs.ravel(), ys.ravel()])[: Y.shape[0]]
    return Y, genes, coords, truth, type_names, ref, ref_genes, labels


def signature_from_reference(ref, labels, type_names):
    """(K, G) per-type mean of the held-out cells — identical aggregation
    to ``flashdeconv_tpu.io.load_reference(method='mean')``, keyed to the
    truth table's cell-type order."""
    X = np.zeros((len(type_names), ref.shape[1]), dtype=np.float64)
    for i, ct in enumerate(type_names):
        mask = labels == ct
        if not mask.any():
            raise ValueError(f"reference has no cells of type {ct!r}")
        X[i] = np.asarray(ref[mask].mean(axis=0)).ravel()
    return X


def run_dataset(name, ddir):
    from flashdeconv_tpu import FlashDeconv
    from flashdeconv_tpu.io.loader import align_genes
    from flashdeconv_tpu.utils.metrics import (
        compute_correlation,
        compute_jsd,
    )

    Y, genes, coords, truth, type_names, ref, ref_genes, labels = (
        load_dataset(ddir)
    )
    X = signature_from_reference(ref, labels, type_names)
    Y_aligned, X_aligned, _ = align_genes(Y, X, genes, ref_genes)

    t0 = time.perf_counter()
    model = FlashDeconv(
        sketch_dim=512, lambda_spatial="auto", n_hvg=2000,
        n_markers_per_type=50, random_state=0,
    )
    pred = model.fit_transform(Y_aligned, X_aligned, coords)
    secs = time.perf_counter() - t0

    r = float(compute_correlation(pred, truth, "pearson"))
    jsd = float(np.mean(compute_jsd(pred, truth)))
    return {
        "design": name, "seed": None, "pearson": round(r, 4),
        "jsd": round(jsd, 4), "seconds": round(secs, 2),
        "n_spots": int(Y.shape[0]), "n_types": int(truth.shape[1]),
        "n_iterations": model.info_["n_iterations"],
        "converged": bool(model.info_["converged"]),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True,
                    help="directory of converted Spotless datasets "
                         "(layout in the module docstring)")
    ap.add_argument("--out", type=str, default=None,
                    help="also write full per-dataset JSON to this path")
    args = ap.parse_args()

    names = sorted(
        d for d in os.listdir(args.data)
        if os.path.isdir(os.path.join(args.data, d))
    )
    if not names:
        print(f"no dataset directories under {args.data}", file=sys.stderr)
        sys.exit(2)

    results, skipped = [], []
    for i, name in enumerate(names):
        ddir = os.path.join(args.data, name)
        missing = [f for f in REQUIRED
                   if not os.path.exists(os.path.join(ddir, f))]
        if missing:
            skipped.append({"dataset": name, "missing": missing})
            print(f"# skip {name}: missing {missing}", file=sys.stderr)
            continue
        row = run_dataset(name, ddir)
        results.append(row)
        print(
            f"# [{len(results)}/{len(names)}] {name}: "
            f"r={row['pearson']:.3f} jsd={row['jsd']:.3f} "
            f"({row['seconds']:.1f}s)",
            file=sys.stderr,
        )

    if not results:
        print("no complete datasets found", file=sys.stderr)
        sys.exit(2)

    rs = [x["pearson"] for x in results]
    out = {
        "metric": "spotless_real_mean_pearson",
        "engine": "jax",
        "value": round(float(np.mean(rs)), 4),
        "unit": "pearson_r",
        "vs_baseline": round(float(np.mean(rs)) / 0.944, 3),
        "min_pearson": round(float(np.min(rs)), 4),
        "n_datasets": len(results),
        "n_skipped": len(skipped),
        "protocol": "Spotless silver standards (Zenodo 10277187), "
                    "converted per benchmarks/spotless_real.py docstring",
        "datasets": results,
        "skipped": skipped,
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("datasets", "skipped")}))


if __name__ == "__main__":
    main()
