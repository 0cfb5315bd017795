"""Test configuration: force a virtual 8-device CPU mesh before jax loads.

Tests run on CPU (deterministic, no accelerator needed) with 8 virtual XLA
host devices so the sharded solver's mesh/halo paths are exercised exactly as they
would be on a real multi-chip slice. x64 is enabled so float64 parity checks
against numpy references are meaningful.
"""

import os
import re

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Force EXACTLY 8 virtual devices: a pre-existing flag with another count
# (e.g. from a different JAX project's shell profile) would silently run
# the 8/16-shard mesh tests on the wrong device count.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count=8" not in flags:
    flags = re.sub(
        r"--xla_force_host_platform_device_count=\d+", "", flags
    )
    os.environ["XLA_FLAGS"] = (
        flags.strip() + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# The CPU backend unless the caller names platforms (the GPU tests run with
# JAX_PLATFORMS=cuda,cpu on a card).
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from flashdeconv_tpu.utils.graph import grid_coords


def make_synthetic(
    n_spots=400,
    n_genes=600,
    n_types=8,
    seed=0,
    grid=True,
    sparse_output=False,
):
    """Spatially smooth synthetic ST dataset with Poisson counts.

    Ground-truth proportions vary smoothly over a grid (soft spatial domains),
    counts are Poisson with gamma-distributed per-spot depth — the same
    generative recipe the reference uses for its integration tests.
    """
    from scipy import sparse as sp

    rng = np.random.RandomState(seed)

    # Sparse-ish nonnegative signatures with distinct per-type programs.
    X = rng.gamma(2.0, 1.0, size=(n_types, n_genes))
    X *= rng.rand(n_types, n_genes) < 0.3
    # Give each type a few exclusive marker genes so types are identifiable.
    # One global draw WITHOUT replacement: independent per-type draws can
    # collide, and the later type's `X[:, cols] = 0` would silently wipe an
    # earlier type's "exclusive" markers.
    markers_per_type = max(3, n_genes // (n_types * 10))
    all_marks = rng.choice(
        n_genes, size=markers_per_type * n_types, replace=False
    )
    for k in range(n_types):
        cols = all_marks[k * markers_per_type:(k + 1) * markers_per_type]
        X[:, cols] = 0.0
        X[k, cols] = rng.gamma(5.0, 2.0, size=markers_per_type)

    if grid:
        coords = grid_coords(n_spots)
    else:
        coords = rng.rand(n_spots, 2) * 50

    # Smooth ground truth: distance-based soft assignment to K spatial centers.
    centers = rng.rand(n_types, 2) * coords.max(axis=0)
    d2 = ((coords[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    logits = -d2 / (2 * (0.25 * coords.max()) ** 2)
    props = np.exp(logits + rng.gumbel(0, 0.3, size=logits.shape))
    props /= props.sum(axis=1, keepdims=True)

    mean = props @ X
    mean = mean / (mean.sum(axis=1, keepdims=True) + 1e-12)
    depth = rng.gamma(3.0, 1500.0, size=(n_spots, 1))
    Y = rng.poisson(mean * depth).astype(np.float64)

    if sparse_output:
        Y = sp.csr_matrix(Y)
    return Y, X, coords, props


@pytest.fixture
def synthetic_small():
    return make_synthetic(n_spots=400, n_genes=600, n_types=8, seed=0)


@pytest.fixture
def synthetic_sparse():
    return make_synthetic(
        n_spots=400, n_genes=600, n_types=8, seed=0, sparse_output=True
    )
