"""Prepared-problem (BCDProblem) contract + degree-cap overflow policy.

The prepared API must be a pure refactoring of ``bcd_solve``: identical
trajectories (bit-level in float64 on CPU), with all host precompute hoisted
into construction so re-solves are device-only.
"""

import numpy as np
import pytest
from scipy import sparse

from flashdeconv_tpu.core.solver import BCDProblem, bcd_solve, prepare_bcd
from flashdeconv_tpu.utils.graph import (
    adjacency_to_padded,
    adjacency_to_padded_capped,
    build_knn_graph,
    grid_coords,
)


@pytest.fixture
def problem():
    rng = np.random.RandomState(7)
    n_spots, n_types, d = 120, 6, 48
    X_sketch = rng.randn(n_types, d)
    beta_true = rng.rand(n_spots, n_types)
    beta_true /= beta_true.sum(axis=1, keepdims=True)
    Y_sketch = beta_true @ X_sketch + 0.1 * rng.randn(n_spots, d)
    coords = rng.rand(n_spots, 2)
    A = build_knn_graph(coords, k=4)
    return Y_sketch, X_sketch, A


@pytest.fixture
def hub_graph():
    """Star-plus-ring graph: spot 0 is a pathological hub (degree N-1)."""
    n = 400
    rows = np.concatenate(
        [np.zeros(n - 1, dtype=np.int64), np.arange(1, n)]
    )
    cols = np.concatenate(
        [np.arange(1, n), np.zeros(n - 1, dtype=np.int64)]
    )
    ring_r = np.arange(n)
    ring_c = (np.arange(n) + 1) % n
    rows = np.concatenate([rows, ring_r, ring_c])
    cols = np.concatenate([cols, ring_c, ring_r])
    A = sparse.csr_matrix(
        (np.ones(rows.size), (rows, cols)), shape=(n, n)
    )
    A.data[:] = 1.0
    return A


class TestPreparedSolve:
    def test_matches_bcd_solve_bitwise(self, problem):
        Y, X, A = problem
        beta_ref, info_ref = bcd_solve(
            Y, X, A, lambda_=0.1, rho=0.01, max_iter=50, dtype=np.float64
        )
        prob = prepare_bcd(Y, X, A, dtype=np.float64)
        beta, info = prob.solve(lambda_=0.1, rho=0.01, max_iter=50)
        np.testing.assert_array_equal(beta, beta_ref)
        assert info["n_iterations"] == info_ref["n_iterations"]
        assert info["final_objective"] == info_ref["final_objective"]

    def test_resolve_is_deterministic(self, problem):
        Y, X, A = problem
        prob = prepare_bcd(Y, X, A, dtype=np.float64)
        beta1, _ = prob.solve(lambda_=0.1, max_iter=30)
        beta2, _ = prob.solve(lambda_=0.1, max_iter=30)
        np.testing.assert_array_equal(beta1, beta2)

    def test_hyperparams_vary_without_reprep(self, problem):
        Y, X, A = problem
        prob = prepare_bcd(Y, X, A, dtype=np.float64)
        for lam in (0.01, 0.1, 1.0):
            beta_ref, info_ref = bcd_solve(
                Y, X, A, lambda_=lam, max_iter=40, dtype=np.float64
            )
            beta, info = prob.solve(lambda_=lam, max_iter=40)
            np.testing.assert_array_equal(beta, beta_ref)
            assert info["n_iterations"] == info_ref["n_iterations"]

    def test_warm_start(self, problem):
        Y, X, A = problem
        prob = prepare_bcd(Y, X, A, dtype=np.float64)
        beta_cold, info_cold = prob.solve(lambda_=0.1, max_iter=100)
        beta_warm, info_warm = prob.solve(
            lambda_=0.1, max_iter=100, beta_init=beta_cold
        )
        assert info_warm["n_iterations"] <= info_cold["n_iterations"]
        # both stop at the tol=1e-4 relative-change point, not the exact
        # minimizer: agreement is solver-tolerance, not bit-level
        np.testing.assert_allclose(beta_warm, beta_cold, atol=1e-4)

    def test_return_device(self, problem):
        Y, X, A = problem
        prob = prepare_bcd(Y, X, A, dtype=np.float64)
        beta_host, _ = prob.solve(lambda_=0.1, max_iter=30)
        beta_dev, _ = prob.solve(lambda_=0.1, max_iter=30, return_device=True)
        assert beta_dev.shape == beta_host.shape
        np.testing.assert_allclose(
            np.asarray(beta_dev, dtype=np.float64), beta_host, rtol=1e-12
        )

    def test_degenerate_and_zero_iter(self):
        prob = BCDProblem(
            np.zeros((0, 8)), np.zeros((3, 8)), sparse.csr_matrix((0, 0))
        )
        beta, info = prob.solve()
        assert beta.shape == (0, 3)
        assert info["converged"]

        rng = np.random.RandomState(0)
        Y, X = rng.rand(10, 8), rng.rand(2, 8)
        A = sparse.csr_matrix((10, 10))
        prob = BCDProblem(Y, X, A, dtype=np.float64)
        beta, info = prob.solve(max_iter=0)
        np.testing.assert_allclose(beta, 0.5)
        assert info["n_iterations"] == 0

    def test_beta_init_shape_validated(self, problem):
        Y, X, A = problem
        prob = prepare_bcd(Y, X, A, dtype=np.float64)
        with pytest.raises(ValueError, match="beta_init shape"):
            prob.solve(beta_init=np.zeros((3, 3)))


class TestSolveProgram:
    """The one-dispatch f32 solve (ops/bcd.solve_program) must reproduce
    the decomposed loop + objective dispatches (ops/bcd.iterate and
    ops/bcd.objective) bitwise on the gather and banded tiers."""

    def _decomposed(self, prob, lambda_, rho, max_iter):
        import jax.numpy as jnp

        from flashdeconv_tpu.ops import bcd

        lam_d = jnp.asarray(lambda_, dtype=prob.dtype)
        rho_d = jnp.asarray(rho * prob.mean_diag, dtype=prob.dtype)
        tol_d = jnp.asarray(1e-30, dtype=prob.dtype)
        beta0 = prob._beta0(None)
        operands = prob._operands()
        beta_d, n_iter, rel = bcd.iterate(
            beta0, operands, lam_d, rho_d, tol_d,
            jnp.asarray(max_iter, jnp.int32), max_iter=max_iter,
            kernel=False, **prob._static(),
        )
        obj = bcd.objective(beta_d, operands, lam_d, rho_d, **prob._static())
        beta = np.asarray(beta_d)[: prob.n_spots]
        if prob.perm is not None:
            unperm = np.empty_like(beta)
            unperm[prob.perm] = beta
            beta = unperm
        return beta, int(n_iter), float(obj)

    def _check(self, prob, tier_attr):
        assert prob.sweep_kernel == "xla"
        assert getattr(prob, tier_attr)
        beta, info = prob.solve(
            lambda_=0.3, rho=0.02, max_iter=5, tol=1e-30,
        )
        assert info["sweep_kernel"] == "xla"
        beta_ref, it_ref, obj_ref = self._decomposed(prob, 0.3, 0.02, 5)
        assert info["n_iterations"] == it_ref
        np.testing.assert_array_equal(
            beta.astype(np.float32), beta_ref.astype(np.float32)
        )
        np.testing.assert_array_equal(
            np.float32(info["final_objective"]), np.float32(obj_ref)
        )

    def test_gather_tier(self, problem):
        Y, X, A = problem  # irregular kNN graph -> gather tier
        prob = prepare_bcd(Y, X, A, dtype=np.float32)
        assert not prob.use_banded
        self._check(prob, "n_spots")

    def test_banded_tier(self):
        # grid graph above the banded-analysis gate (8192 spots); the GPU
        # sweep kernel stays off on the CPU test backend, so this is the
        # XLA banded tier
        side = 96
        coords = grid_coords(side=side)
        A = build_knn_graph(coords, k=4)
        n = A.shape[0]
        rng = np.random.RandomState(3)
        X = rng.randn(5, 32)
        Y = rng.rand(n, 5) @ X + 0.1 * rng.randn(n, 32)
        prob = prepare_bcd(Y, X, A, dtype=np.float32, coords=coords)
        assert prob.use_banded
        self._check(prob, "use_banded")


class TestVerboseCadence:
    def test_objective_logged_at_iteration_zero(self, problem, capsys):
        """Reference cadence: objective after sweeps 0, 10, 20, ...
        (reference flashdeconv/core/solver.py:399-404)."""
        Y, X, A = problem
        _, info = bcd_solve(
            Y, X, A, lambda_=0.1, max_iter=25, tol=0.0, verbose=True,
            dtype=np.float64,
        )
        out = capsys.readouterr().out
        lines = [ln for ln in out.splitlines() if ln.startswith("Iteration")]
        labels = [int(ln.split()[1].rstrip(":")) for ln in lines]
        # tol=0 forces the full budget: boundaries at 0, 10, 20, 24
        assert labels == [0, 10, 20, 24]
        assert len(info["objectives"]) == 4


class TestDegreeCap:
    def test_capped_table_matches_uncapped(self, hub_graph):
        nbr_u, cnt_u = adjacency_to_padded(hub_graph)
        nbr_c, cnt_c, ov_s, ov_d = adjacency_to_padded_capped(
            hub_graph, max_degree=8
        )
        assert nbr_c.shape[1] == 8
        # the hub's ring edges coincide with star edges: degree is n-1
        assert nbr_u.shape[1] == hub_graph.shape[0] - 1
        np.testing.assert_array_equal(cnt_c, cnt_u)  # TRUE degrees kept
        # every edge is either in the table or the overflow list
        n_table = int((nbr_c < hub_graph.shape[0]).sum())
        assert n_table + ov_s.size == hub_graph.nnz

    def test_cap_noop_when_not_binding(self, problem):
        _, _, A = problem
        nbr_u, cnt_u = adjacency_to_padded(A)
        nbr_c, cnt_c, ov_s, ov_d = adjacency_to_padded_capped(A)
        np.testing.assert_array_equal(nbr_c, nbr_u)
        np.testing.assert_array_equal(cnt_c, cnt_u)
        assert ov_s.size == 0

    def test_solve_with_cap_matches_exact(self, hub_graph):
        rng = np.random.RandomState(3)
        n = hub_graph.shape[0]
        X = rng.randn(5, 32)
        Y = np.abs(rng.randn(n, 5)) @ X + 0.05 * rng.randn(n, 32)

        beta_exact, info_e = bcd_solve(
            Y, X, hub_graph, lambda_=0.2, max_iter=60, dtype=np.float64
        )
        beta_cap, info_c = bcd_solve(
            Y, X, hub_graph, lambda_=0.2, max_iter=60, dtype=np.float64,
            max_degree=8,
        )
        # same math, different summation order: allclose, not bit-equal
        np.testing.assert_allclose(beta_cap, beta_exact, rtol=1e-8, atol=1e-10)
        assert info_c["n_iterations"] == info_e["n_iterations"]

    def test_solver_memory_capped(self, hub_graph):
        rng = np.random.RandomState(3)
        n = hub_graph.shape[0]
        X = rng.randn(5, 32)
        Y = np.abs(rng.randn(n, 5)) @ X
        prob = BCDProblem(Y, X, hub_graph, dtype=np.float64, max_degree=8)
        assert prob.nbr_d.shape == (n, 8)
        assert prob.ov_src_d is not None


class TestPreparedSharded:
    """ShardedBCDProblem / prepare_sharded_bcd: prepare-once contract on
    the virtual CPU mesh — re-solves must be identical to one-shot
    sharded_bcd_solve calls for both strategies, with/without the
    precomputed xty/yty reductions and the re-sort permutation."""

    def _grid_problem(self, side=20, k_types=5, d=32, seed=11,
                      scramble=False):
        rng = np.random.RandomState(seed)
        coords = grid_coords(side=side)
        n = coords.shape[0]
        if scramble:
            coords = coords[rng.permutation(n)]
        X_sketch = rng.randn(k_types, d)
        Y_sketch = np.abs(rng.randn(n, k_types)) @ X_sketch \
            + 0.05 * rng.randn(n, d)
        A = build_knn_graph(coords, k=4)
        return Y_sketch, X_sketch, A, coords

    def _irregular_problem(self, n=300, k_types=5, d=32, seed=12):
        rng = np.random.RandomState(seed)
        coords = rng.rand(n, 2) * 30
        X_sketch = rng.randn(k_types, d)
        Y_sketch = np.abs(rng.randn(n, k_types)) @ X_sketch \
            + 0.05 * rng.randn(n, d)
        A = build_knn_graph(coords, k=4)
        return Y_sketch, X_sketch, A, coords

    @pytest.mark.parametrize("make,strategy", [
        ("_grid_problem", "banded"),
        ("_irregular_problem", "halo"),
    ])
    def test_resolve_matches_oneshot_bitwise(self, make, strategy):
        from flashdeconv_tpu.parallel import (
            prepare_sharded_bcd, sharded_bcd_solve,
        )

        Y, X, A, coords = getattr(self, make)()
        problem = prepare_sharded_bcd(
            Y, X, A, coords=coords, n_shards=4, dtype=np.float64,
        )
        assert problem.strategy == strategy
        for lam in (0.1, 0.5):
            beta_p, info_p = problem.solve(
                lambda_=lam, max_iter=40, tol=1e-5
            )
            beta_1, info_1 = sharded_bcd_solve(
                Y, X, A, coords=coords, n_shards=4, dtype=np.float64,
                lambda_=lam, max_iter=40, tol=1e-5,
            )
            np.testing.assert_array_equal(beta_p, beta_1)
            assert info_p["n_iterations"] == info_1["n_iterations"]
            assert info_p["final_objective"] == info_1["final_objective"]

    @pytest.mark.parametrize("make", ["_grid_problem", "_irregular_problem"])
    def test_xty_yty_precomputed_matches(self, make):
        """Y_sketch=None with xty/yty supplied: identical solve (the
        sharded solvers consume the sketch only through these)."""
        from flashdeconv_tpu.parallel import prepare_sharded_bcd

        Y, X, A, coords = getattr(self, make)()
        xty = Y @ X.T
        yty = float(np.einsum("ij,ij->", Y, Y))
        p_full = prepare_sharded_bcd(
            Y, X, A, coords=coords, n_shards=4, dtype=np.float64,
        )
        p_red = prepare_sharded_bcd(
            None, X, A, coords=coords, n_shards=4, dtype=np.float64,
            xty=xty, yty=yty,
        )
        b_full, i_full = p_full.solve(lambda_=0.3, max_iter=40)
        b_red, i_red = p_red.solve(lambda_=0.3, max_iter=40)
        np.testing.assert_array_equal(b_red, b_full)
        assert i_red["final_objective"] == i_full["final_objective"]

    def test_scrambled_grid_prepared_resort(self, monkeypatch):
        """Prepared problem on a scrambled grid: re-sort happens once at
        prepare; every solve returns beta in the ORIGINAL order and
        warm-starts compose with the permutation."""
        import flashdeconv_tpu.parallel.solver as psolver
        from flashdeconv_tpu.parallel import prepare_sharded_bcd

        monkeypatch.setattr(psolver, "RESORT_MIN_SPOTS", 0)
        Y, X, A, coords = self._grid_problem(scramble=True)
        problem = prepare_sharded_bcd(
            Y, X, A, coords=coords, n_shards=4, dtype=np.float64,
        )
        assert problem.strategy == "banded"

        beta0, info0 = problem.solve(lambda_=0.2, max_iter=40, tol=1e-5)
        # reference: single-device solve in the original order
        beta_ref, _ = bcd_solve(
            Y, X, A, lambda_=0.2, max_iter=40, tol=1e-5, dtype=np.float64,
        )
        np.testing.assert_allclose(beta0, beta_ref, atol=1e-8)

        # warm start from the returned (original-order) beta converges
        # in few sweeps and keeps the original order (a permutation error
        # would produce O(1) differences; sweeps only polish at tol scale)
        beta_w, info_w = problem.solve(
            lambda_=0.2, max_iter=40, tol=1e-5, beta_init=beta0
        )
        np.testing.assert_allclose(beta_w, beta0, atol=1e-3)
        assert info_w["n_iterations"] <= info0["n_iterations"]

    def test_prepared_beta_init_validation(self):
        from flashdeconv_tpu.parallel import prepare_sharded_bcd

        Y, X, A, coords = self._irregular_problem()
        problem = prepare_sharded_bcd(
            Y, X, A, coords=coords, n_shards=4, dtype=np.float64,
        )
        with pytest.raises(ValueError, match="beta_init shape"):
            problem.solve(beta_init=np.zeros((3, 3)))

    def test_prepare_rejects_empty(self):
        from flashdeconv_tpu.parallel import prepare_sharded_bcd

        with pytest.raises(ValueError, match="non-empty"):
            prepare_sharded_bcd(
                np.zeros((0, 8)), np.zeros((5, 8)), sparse.csr_matrix((0, 0))
            )

    @pytest.mark.parametrize("make", ["_grid_problem", "_irregular_problem"])
    def test_prepare_rejects_mismatched_xty(self, make):
        """A wrong-shaped precomputed xty must fail at prepare with a named
        operand, not as an opaque scatter/jit error later."""
        from flashdeconv_tpu.parallel import prepare_sharded_bcd

        Y, X, A, coords = getattr(self, make)()
        bad = np.zeros((A.shape[0] + 1, X.shape[0]))  # one row too many
        with pytest.raises(ValueError, match="xty shape"):
            prepare_sharded_bcd(
                None, X, A, coords=coords, n_shards=4, dtype=np.float64,
                xty=bad, yty=1.0,
            )
        bad_k = np.zeros((A.shape[0], X.shape[0] + 2))  # (N, d)-like
        with pytest.raises(ValueError, match="xty shape"):
            prepare_sharded_bcd(
                None, X, A, coords=coords, n_shards=4, dtype=np.float64,
                xty=bad_k, yty=1.0,
            )
