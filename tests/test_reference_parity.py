"""Golden parity tests against the reference implementation.

The reference package (pure numpy/scipy + Numba kernels run as plain Python
via a stub) is imported from /root/reference as a test oracle. Skipped
entirely when the reference is not mounted.
"""

import numpy as np
import pytest

from reference_harness import import_reference, reference_available

pytestmark = pytest.mark.skipif(
    not reference_available(), reason="reference package not mounted"
)


@pytest.fixture(scope="module")
def ref():
    return import_reference()


def test_harness_path_hygiene(ref):
    """import_reference must leave /root/reference OFF sys.path: its
    regular `tests` package (tests/__init__.py) beats this repo's
    namespace `tests` package from ANY path position, so a lingering
    entry broke `from tests.fake_anndata import ...` for every test that
    ran after a parity test (reproduced before the fix)."""
    import importlib
    import sys

    assert "/root/reference" not in sys.path
    mod = importlib.import_module("tests.fake_anndata")
    assert "reference" not in (mod.__file__ or "")


def _problem(seed=0, n_spots=60, n_types=6, d=32):
    rng = np.random.RandomState(seed)
    X = rng.randn(n_types, d)
    bt = rng.rand(n_spots, n_types)
    bt /= bt.sum(axis=1, keepdims=True)
    Y = bt @ X + 0.05 * rng.randn(n_spots, d)
    coords = rng.rand(n_spots, 2)
    return Y, X, coords


class TestSketchParity:
    def test_countsketch_bit_parity(self, ref):
        from flashdeconv_tpu.core.sketching import build_countsketch_matrix

        lv = np.random.RandomState(5).rand(300)
        ours = build_countsketch_matrix(300, 64, leverage_scores=lv, random_state=42)
        import flashdeconv.core.sketching as ref_sk

        theirs = ref_sk.build_countsketch_matrix(
            300, 64, leverage_scores=lv, random_state=42
        )
        assert (ours != theirs).nnz == 0

    def test_countsketch_uniform_parity(self, ref):
        from flashdeconv_tpu.core.sketching import build_countsketch_matrix
        import flashdeconv.core.sketching as ref_sk

        ours = build_countsketch_matrix(200, 32, random_state=0)
        theirs = ref_sk.build_countsketch_matrix(200, 32, random_state=0)
        assert (ours != theirs).nnz == 0

    def test_rademacher_parity(self, ref):
        from flashdeconv_tpu.core.sketching import build_sparse_rademacher_matrix
        import flashdeconv.core.sketching as ref_sk

        lv = np.random.RandomState(1).rand(150)
        ours = build_sparse_rademacher_matrix(
            150, 16, sparsity=0.1, leverage_scores=lv, random_state=9
        )
        theirs = ref_sk.build_sparse_rademacher_matrix(
            150, 16, sparsity=0.1, leverage_scores=lv, random_state=9
        )
        np.testing.assert_allclose(ours.toarray(), theirs.toarray())


class TestGenesParity:
    def test_hvg_parity_dense_and_sparse(self, ref):
        from scipy import sparse

        from flashdeconv_tpu.utils.genes import select_hvg
        import flashdeconv.utils.genes as ref_genes

        rng = np.random.RandomState(3)
        Y = rng.poisson(rng.gamma(1.0, 2.0, size=(120, 400)) * 3).astype(float)
        np.testing.assert_array_equal(
            select_hvg(Y, n_top=80), ref_genes.select_hvg(Y, n_top=80)
        )
        Ys = sparse.csr_matrix(Y)
        np.testing.assert_array_equal(
            select_hvg(Ys, n_top=80), ref_genes.select_hvg(Ys, n_top=80)
        )

    @pytest.mark.parametrize("method", ["diff", "ratio", "specificity"])
    def test_markers_parity(self, ref, method):
        from flashdeconv_tpu.utils.genes import select_markers
        import flashdeconv.utils.genes as ref_genes

        X = np.random.RandomState(4).rand(6, 200)
        ours_idx, ours_assign = select_markers(X, n_markers=12, method=method)
        ref_idx, ref_assign = ref_genes.select_markers(X, n_markers=12, method=method)
        np.testing.assert_array_equal(ours_idx, ref_idx)
        np.testing.assert_array_equal(ours_assign, ref_assign)

    def test_leverage_parity(self, ref):
        from flashdeconv_tpu.utils.genes import compute_leverage_scores
        import flashdeconv.utils.genes as ref_genes

        X = np.random.RandomState(5).rand(7, 150)
        np.testing.assert_allclose(
            compute_leverage_scores(X),
            ref_genes.compute_leverage_scores(X),
            rtol=1e-10,
        )


class TestGraphParity:
    def test_knn_parity(self, ref):
        from flashdeconv_tpu.utils.graph import build_knn_graph
        import flashdeconv.utils.graph as ref_graph

        coords = np.random.RandomState(6).rand(80, 2)
        ours = build_knn_graph(coords, k=6)
        theirs = ref_graph.build_knn_graph(coords, k=6)
        assert (ours != theirs).nnz == 0

    def test_radius_parity(self, ref):
        from flashdeconv_tpu.utils.graph import build_radius_graph
        import flashdeconv.utils.graph as ref_graph

        coords = np.random.RandomState(7).rand(80, 2)
        ours = build_radius_graph(coords, radius=0.15)
        theirs = ref_graph.build_radius_graph(coords, radius=0.15)
        assert (ours != theirs).nnz == 0

    def test_grid_parity(self, ref):
        """build_grid_graph parity (reference utils/graph.py:136-172):
        square lattice, hex-offset lattice, explicit spacing, and the
        jittered-coordinates auto-detection path."""
        from flashdeconv_tpu.utils.graph import build_grid_graph
        import flashdeconv.utils.graph as ref_graph

        xs, ys = np.meshgrid(np.arange(12.0), np.arange(10.0))
        square = np.column_stack([xs.ravel(), ys.ravel()])
        hexa = square.copy()
        hexa[:, 0] += (hexa[:, 1] % 2) * 0.5  # offset rows (Visium-like)
        jitter = square + np.random.RandomState(9).normal(
            0, 0.03, size=square.shape
        )
        for coords in (square, hexa, jitter):
            ours = build_grid_graph(coords)
            theirs = ref_graph.build_grid_graph(coords)
            assert (ours != theirs).nnz == 0
        ours = build_grid_graph(square, grid_spacing=2.0)
        theirs = ref_graph.build_grid_graph(square, grid_spacing=2.0)
        assert (ours != theirs).nnz == 0


class TestPreprocessParity:
    @pytest.mark.parametrize("method", ["log_cpm", "pearson", "raw"])
    @pytest.mark.parametrize("sparse_input", [False, True])
    def test_preprocess_parity(self, ref, method, sparse_input):
        from scipy import sparse

        from flashdeconv_tpu.core.deconv import preprocess_data
        from flashdeconv.core.deconv import FlashDeconv as RefModel

        rng = np.random.RandomState(8)
        Y = rng.poisson(2.0, size=(50, 120)).astype(float)
        X = rng.gamma(2.0, 1.0, size=(5, 120))
        Y_in = sparse.csr_matrix(Y) if sparse_input else Y

        ours_Y, ours_X = preprocess_data(Y_in, X, method)
        ref_model = RefModel()
        ref_Y, ref_X = ref_model._preprocess_data(Y_in, X, method)

        if sparse.issparse(ours_Y):
            ours_Y = ours_Y.toarray()
        if sparse.issparse(ref_Y):
            ref_Y = ref_Y.toarray()
        np.testing.assert_allclose(ours_Y, ref_Y, rtol=1e-12)
        np.testing.assert_allclose(ours_X, ref_X, rtol=1e-12)


class TestSolverParity:
    def test_beta_close_to_reference(self, ref):
        """Full bcd_solve trajectory parity in float64 (pure-Python reference)."""
        from flashdeconv_tpu.core.solver import bcd_solve
        from flashdeconv_tpu.utils.graph import build_knn_graph
        import flashdeconv.core.solver as ref_solver

        Y, X, coords = _problem(seed=11, n_spots=50, n_types=5, d=24)
        A = build_knn_graph(coords, k=4)

        ours, info_ours = bcd_solve(
            Y, X, A, lambda_=0.1, rho=0.01, max_iter=40, tol=1e-5,
            dtype=np.float64,
        )
        theirs, info_ref = ref_solver.bcd_solve(
            Y, X, A, lambda_=0.1, rho=0.01, max_iter=40, tol=1e-5
        )
        np.testing.assert_allclose(ours, theirs, rtol=1e-8, atol=1e-10)
        assert info_ours["n_iterations"] == info_ref["n_iterations"]
        assert info_ours["converged"] == info_ref["converged"]
        np.testing.assert_allclose(
            info_ours["final_objective"], info_ref["final_objective"], rtol=1e-8
        )

    def test_end_to_end_proportions_parity(self, ref):
        """fit_transform parity on a small synthetic dataset (float64)."""
        from flashdeconv_tpu import FlashDeconv
        from flashdeconv.core.deconv import FlashDeconv as RefModel

        from conftest import make_synthetic

        Y, X, coords, _ = make_synthetic(n_spots=100, n_genes=250, n_types=5)
        kw = dict(
            sketch_dim=64, n_hvg=120, n_markers_per_type=10, random_state=0,
            max_iter=30,
        )
        P_ours = FlashDeconv(solver_dtype=np.float64, **kw).fit_transform(
            Y, X, coords
        )
        P_ref = RefModel(**kw).fit_transform(Y, X, coords)
        np.testing.assert_allclose(P_ours, P_ref, rtol=1e-6, atol=1e-8)

    @pytest.mark.parametrize("method", ["pearson", "raw"])
    def test_end_to_end_parity_sparse_fused_preprocess(self, ref, method):
        """Sparse-CSR fit_transform parity for the non-default preprocess
        modes (float64). On our side sparse input engages the fused
        subset->column-scale->sketch native path (when available), which is
        bit-identical to the scipy staging the reference runs — so parity
        holds at the same tolerance as the log_cpm e2e test."""
        from scipy import sparse

        from flashdeconv_tpu import FlashDeconv
        from flashdeconv.core.deconv import FlashDeconv as RefModel

        from conftest import make_synthetic

        Y, X, coords, _ = make_synthetic(n_spots=100, n_genes=250, n_types=5)
        Ysp = sparse.csr_matrix(Y)
        kw = dict(
            sketch_dim=64, n_hvg=120, n_markers_per_type=10, random_state=0,
            max_iter=30, preprocess=method,
        )
        P_ours = FlashDeconv(solver_dtype=np.float64, **kw).fit_transform(
            Ysp, X, coords
        )
        P_ref = RefModel(**kw).fit_transform(Ysp, X, coords)
        np.testing.assert_allclose(P_ours, P_ref, rtol=1e-6, atol=1e-8)


class TestLargeKParity:
    """Large K: above the GPU sweep kernel's cap the solve runs the XLA
    coordinate pass — lax.fori_loop with dynamic slices for K >
    _UNROLL_MAX_K (64; the unrolled tier below it is exercised by every
    small-K test in the suite, and the fori tier is pinned bitwise to it by
    the monkeypatch test at the bottom). Reference trajectory parity must
    hold on the fori tier well above the cap (129 / 160 / 200).
    """

    @pytest.mark.parametrize("n_types", [129, 160, 200])
    def test_beta_close_to_reference_large_k(self, ref, n_types):
        import flashdeconv.core.solver as ref_solver

        from flashdeconv_tpu.core.solver import bcd_solve
        from flashdeconv_tpu.utils.graph import build_knn_graph

        Y, X, coords = _problem(seed=3, n_spots=30, n_types=n_types, d=256)
        A = build_knn_graph(coords, k=4)

        ours, info_ours = bcd_solve(
            Y, X, A, lambda_=0.1, rho=0.01, max_iter=15, tol=1e-5,
            dtype=np.float64,
        )
        theirs, info_ref = ref_solver.bcd_solve(
            Y, X, A, lambda_=0.1, rho=0.01, max_iter=15, tol=1e-5
        )
        np.testing.assert_allclose(ours, theirs, rtol=1e-8, atol=1e-10)
        assert info_ours["n_iterations"] == info_ref["n_iterations"]
