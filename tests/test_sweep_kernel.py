"""The GPU sweep kernel (ops/sweep_kernel): interpret-mode parity on CPU.

The kernel must reproduce XLA's sweeps (ops/bcd) — the banded sweep with
its remainder gather, and the padded-gather sweep — to float32 rounding:
the same update formula, another order of the f32 sums. These tests run the
kernel through the Pallas interpreter (``interpret=True``); the tests marked
``gpu`` run the compiled kernel on a card and skip elsewhere.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from flashdeconv_tpu.ops import bcd
from flashdeconv_tpu.ops.sweep_kernel import (
    KERNEL_MAX_K,
    _block,
    bcd_iterate_kernel,
    sweep,
)
from flashdeconv_tpu.utils.graph import (
    adjacency_to_padded,
    banded_split,
    build_knn_graph,
    grid_coords,
)

# float32 arithmetic in another summation order: a few ulp per operation.
ATOL = 2e-5


def _operands(n_types, A, seed=0, max_offsets=32, min_coverage=0.9):
    """Sweep operands for adjacency ``A``: banded split (bands + padded
    remainder table), degrees, random beta/Xty/XtX."""
    n = A.shape[0]
    offsets, masks, A_rest = banded_split(
        A, max_offsets=max_offsets, min_coverage=min_coverage
    )
    if A_rest.nnz:
        rest, _ = adjacency_to_padded(A_rest)
    else:
        rest = np.zeros((n, 0), np.int32)
    rng = np.random.RandomState(seed)
    Xs = rng.randn(n_types, 2 * n_types + 8)
    return {
        "beta": jnp.asarray(np.abs(rng.randn(n, n_types)), jnp.float32),
        "Xty": jnp.asarray(np.abs(rng.randn(n, n_types)) * 5, jnp.float32),
        "XtX": jnp.asarray(Xs @ Xs.T, jnp.float32),
        "offsets": tuple(int(o) for o in offsets),
        "halo": int(np.max(np.abs(offsets))) if offsets.size else 0,
        "masks": jnp.asarray(masks.astype(np.uint8)),
        "rest": jnp.asarray(rest),
        "nnb": jnp.asarray(np.diff(A.tocsr().indptr).astype(np.float32)),
    }


def _grid(n_types=6, side=40, seed=0, **kw):
    return _operands(n_types, build_knn_graph(grid_coords(side=side), k=6),
                     seed=seed, **kw)


def _xla_banded(p, lam, rho):
    return bcd.bcd_sweep_banded(
        p["beta"], p["Xty"], p["XtX"], p["offsets"], p["masks"], p["rest"],
        p["nnb"], jnp.float32(lam), jnp.float32(rho), p["halo"],
    )


def _kernel(p, lam, rho, gather=False):
    rest = p["rest"]
    out, diff, mabs = sweep(
        p["beta"].T, p["Xty"].T, p["XtX"], p["nnb"], jnp.float32(lam),
        jnp.float32(rho),
        () if gather else p["offsets"],
        None if gather else p["masks"],
        rest.T if rest.shape[1] else None,
        interpret=True,
    )
    return out.T, diff, mabs


def _assert_sweep_close(got, ref):
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               atol=ATOL)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-6)


@pytest.mark.parametrize("n_types", [1, 8, 20, KERNEL_MAX_K])
def test_banded_sweep_matches_xla(n_types):
    p = _grid(n_types=n_types, side=24 if n_types > 20 else 40)
    assert p["offsets"] and p["rest"].shape[1] == 0   # bands only
    _assert_sweep_close(_kernel(p, 0.5, 0.1), _xla_banded(p, 0.5, 0.1))


@pytest.mark.parametrize("lam,rho", [(0.0, 0.0), (0.8, 0.3), (3.0, 2.0)])
def test_banded_sweep_hyperparameters(lam, rho):
    p = _grid(seed=3)
    _assert_sweep_close(_kernel(p, lam, rho), _xla_banded(p, lam, rho))


def test_bands_plus_remainder():
    """Eight bands leave the sparse boundary offsets in the remainder
    table, which the kernel gathers per slot."""
    p = _grid(seed=7, max_offsets=8, min_coverage=0.5)
    assert p["offsets"] and p["rest"].shape[1] > 0
    _assert_sweep_close(_kernel(p, 0.6, 0.08), _xla_banded(p, 0.6, 0.08))


def test_holey_tissue_mask():
    """Tissue-masked grid (random missing bins, the realistic Visium HD
    case): the band masks carry the holes."""
    rng = np.random.RandomState(11)
    coords = grid_coords(side=48)
    coords = coords[rng.rand(coords.shape[0]) > 0.3]
    p = _operands(5, build_knn_graph(coords, k=6), seed=11,
                  min_coverage=0.0)
    assert p["offsets"]
    _assert_sweep_close(_kernel(p, 0.6, 0.05), _xla_banded(p, 0.6, 0.05))


@pytest.mark.parametrize("n_types", [4, 40])
@pytest.mark.parametrize("extra", [-1, 1, 17])
def test_ragged_tail(n_types, extra):
    """Spot counts off the tile size (two tile sizes, by K): the tail is
    masked, not padded."""
    n = 7 * _block(n_types) + extra
    p = _operands(n_types, build_knn_graph(grid_coords(n), k=6), seed=n)
    assert p["beta"].shape[0] == n
    _assert_sweep_close(_kernel(p, 0.4, 0.05), _xla_banded(p, 0.4, 0.05))


def test_tile_size_follows_k():
    assert _block(20) == 64 and _block(32) == 64
    assert _block(33) == 32 and _block(KERNEL_MAX_K) == 32


def test_gather_tier_sweep_matches_xla():
    """No bands, the whole padded neighbour table as the remainder: the
    kernel's form of the irregular-graph gather sweep."""
    rng = np.random.RandomState(2)
    A = build_knn_graph(rng.rand(700, 2) * 30, k=6)
    p = _operands(6, A, seed=2)
    nbr, _ = adjacency_to_padded(A)
    p["rest"] = jnp.asarray(nbr)
    ref = bcd.bcd_sweep(p["beta"], p["Xty"], p["XtX"], p["rest"], p["nnb"],
                        jnp.float32(0.7), jnp.float32(0.1))
    _assert_sweep_close(_kernel(p, 0.7, 0.1, gather=True), ref)


def test_dead_spots_stay_zero():
    """Spots with zero beta, zero Xty and no neighbours stay exactly 0."""
    p = _grid(seed=1)
    dead = np.zeros(p["beta"].shape[0], bool)
    dead[-50:] = True
    p["beta"] = p["beta"].at[-50:].set(0.0)
    p["Xty"] = p["Xty"].at[-50:].set(0.0)
    p["masks"] = p["masks"].at[:, -50:].set(0)
    p["nnb"] = p["nnb"].at[-50:].set(0.0)
    out, _, _ = _kernel(p, 0.7, 0.2)
    assert np.all(np.asarray(out)[dead] == 0.0)


def test_iterate_matches_xla_sweep_count():
    """A converging solve loop: same sweep count, same beta to f32."""
    p = _grid(seed=2)
    args = (jnp.float32(0.5), jnp.float32(0.05), jnp.float32(1e-3), 60)
    ref, it_ref, _ = bcd.bcd_iterate_banded(
        p["beta"], p["Xty"], p["XtX"], p["offsets"], p["masks"], p["rest"],
        p["nnb"], *args, p["halo"],
    )
    got, it, _ = bcd_iterate_kernel(
        p["beta"], p["Xty"], p["XtX"], p["nnb"], *args,
        offsets=p["offsets"], masks=p["masks"], rest=p["rest"],
        interpret=True,
    )
    assert int(it_ref) < 60 and int(it) == int(it_ref)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("tier", ["banded", "gather"])
def test_solve_program_kernel_matches_xla(tier):
    """The one-dispatch solve with ``kernel=True`` against ``kernel=False``
    on both tiers: beta, sweep count and objective."""
    if tier == "banded":
        p = _grid(seed=5)
        ops = {k: p[k] for k in ("Xty", "XtX", "nnb", "masks", "rest")}
        static = dict(tier="banded", offsets=p["offsets"], halo=p["halo"])
    else:
        rng = np.random.RandomState(5)
        A = build_knn_graph(rng.rand(600, 2) * 25, k=6)
        p = _operands(5, A, seed=5)
        ops = {k: p[k] for k in ("Xty", "XtX", "nnb")}
        ops["nbr"] = jnp.asarray(adjacency_to_padded(A)[0])
        static = dict(tier="gather", offsets=None, halo=0)
    ops["YtY"] = jnp.float32(1e4)
    n = p["beta"].shape[0]
    inv = jnp.asarray(np.random.RandomState(0).permutation(n - 3),
                      jnp.int32)
    outs = [
        bcd.solve_program(
            None, ops, inv, jnp.float32(0.4), jnp.float32(0.05),
            jnp.float32(0.0), jnp.asarray(4, jnp.int32), max_iter=4,
            kernel=kernel, n_spots=n - 3, interpret=kernel, **static,
        )
        for kernel in (True, False)
    ]
    assert outs[0][0].shape == (n - 3, p["beta"].shape[1])
    np.testing.assert_allclose(np.asarray(outs[0][0]),
                               np.asarray(outs[1][0]), atol=ATOL)
    assert int(outs[0][1]) == int(outs[1][1]) == 4
    np.testing.assert_allclose(float(outs[0][3]), float(outs[1][3]),
                               rtol=1e-5)


def test_kernel_refuses_overflow_edges():
    """A degree-capped gather table spills edges the kernel cannot read."""
    ops = {"Xty": None, "XtX": None, "nnb": None, "nbr": None,
           "ov_src": None, "ov_dst": None}
    with pytest.raises(ValueError, match="overflow"):
        bcd.iterate(None, ops, 0.1, 0.1, 0.0, None, tier="gather",
                    offsets=None, halo=0, max_iter=1, kernel=True)


@pytest.fixture
def gpu():
    """Skips unless JAX's default device is a GPU."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu)")


@pytest.mark.gpu
@pytest.mark.parametrize("n_types", [8, 20, KERNEL_MAX_K])
def test_compiled_kernel_matches_xla_on_gpu(gpu, n_types):
    p = _grid(n_types=n_types, side=256, seed=n_types, max_offsets=8,
              min_coverage=0.5)
    got = sweep(p["beta"].T, p["Xty"].T, p["XtX"], p["nnb"],
                jnp.float32(0.5), jnp.float32(0.1), p["offsets"], p["masks"],
                p["rest"].T)
    _assert_sweep_close((got[0].T, got[1], got[2]),
                        _xla_banded(p, 0.5, 0.1))


@pytest.mark.gpu
def test_compiled_gather_kernel_matches_xla_on_gpu(gpu):
    rng = np.random.RandomState(4)
    A = build_knn_graph(rng.rand(60_000, 2) * 250, k=6)
    p = _operands(20, A, seed=4)
    nbr = jnp.asarray(adjacency_to_padded(A)[0])
    ref = bcd.bcd_sweep(p["beta"], p["Xty"], p["XtX"], nbr, p["nnb"],
                        jnp.float32(0.7), jnp.float32(0.1))
    got = sweep(p["beta"].T, p["Xty"].T, p["XtX"], p["nnb"],
                jnp.float32(0.7), jnp.float32(0.1), rest_t=nbr.T)
    _assert_sweep_close((got[0].T, got[1], got[2]), ref)
