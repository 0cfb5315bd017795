"""Sketching contracts (mirrors reference tests/test_sketching.py scope)."""

import numpy as np
import pytest
from scipy import sparse

from flashdeconv_tpu.core.sketching import (
    build_countsketch_matrix,
    build_sparse_rademacher_matrix,
    make_countsketch_op,
    project_to_sketch,
    sketch_data,
)


class TestCountSketch:
    def test_shape(self):
        Omega = build_countsketch_matrix(100, 32, random_state=0)
        assert Omega.shape == (100, 32)

    def test_one_nnz_per_row(self):
        Omega = build_countsketch_matrix(200, 64, random_state=1)
        nnz_per_row = np.diff(Omega.tocsr().indptr)
        assert np.all(nnz_per_row == 1)

    def test_seed_reproducible(self):
        a = build_countsketch_matrix(150, 32, random_state=7)
        b = build_countsketch_matrix(150, 32, random_state=7)
        assert (a != b).nnz == 0

    def test_leverage_amplitudes(self):
        leverage = np.zeros(100)
        leverage[:10] = 1.0  # all mass on the first 10 genes
        Omega = build_countsketch_matrix(
            100, 32, leverage_scores=leverage, random_state=0
        )
        mags = np.abs(Omega.toarray()).max(axis=1)
        # Column normalization rescales shared buckets, but on average the
        # high-leverage genes must still carry larger amplitudes.
        assert mags[:10].mean() > 1.5 * mags[10:].mean()

    def test_op_and_csr_agree(self):
        op = make_countsketch_op(120, 16, random_state=3)
        np.testing.assert_allclose(op.to_csr().toarray(), op.to_dense(np.float64))


class TestRademacher:
    def test_shape_and_density(self):
        Omega = build_sparse_rademacher_matrix(
            200, 32, sparsity=0.1, random_state=0
        )
        assert Omega.shape == (200, 32)
        density = Omega.nnz / (200 * 32)
        assert 0.02 < density < 0.5

    def test_every_column_nonempty(self):
        Omega = build_sparse_rademacher_matrix(50, 16, sparsity=0.05, random_state=2)
        col_counts = np.diff(Omega.tocsc().indptr)
        assert np.all(col_counts >= 1)


class TestProjection:
    def test_shapes(self):
        rng = np.random.RandomState(0)
        Y = rng.rand(40, 100)
        X = rng.rand(5, 100)
        Omega = build_countsketch_matrix(100, 16, random_state=0)
        Ys, Xs = project_to_sketch(Y, X, Omega)
        assert Ys.shape == (40, 16)
        assert Xs.shape == (5, 16)
        assert not sparse.issparse(Ys) and not sparse.issparse(Xs)

    def test_sparse_input(self):
        rng = np.random.RandomState(1)
        Y = sparse.random(30, 80, density=0.1, random_state=1, format="csr")
        X = rng.rand(4, 80)
        Omega = build_countsketch_matrix(80, 16, random_state=0)
        Ys, Xs = project_to_sketch(Y, X, Omega)
        np.testing.assert_allclose(Ys, Y.toarray() @ Omega.toarray(), atol=1e-12)

    def test_linearity(self):
        rng = np.random.RandomState(2)
        Y1, Y2 = rng.rand(20, 60), rng.rand(20, 60)
        X = rng.rand(3, 60)
        Omega = build_countsketch_matrix(60, 16, random_state=0)
        s12, _ = project_to_sketch(Y1 + Y2, X, Omega)
        s1, _ = project_to_sketch(Y1, X, Omega)
        s2, _ = project_to_sketch(Y2, X, Omega)
        np.testing.assert_allclose(s12, s1 + s2, atol=1e-10)

    def test_norm_preservation(self):
        # CountSketch with the sqrt(G/d) scaling approximately preserves
        # squared norms in expectation.
        rng = np.random.RandomState(3)
        Y = rng.randn(50, 2000)
        norms = []
        for seed in range(5):
            Omega = build_countsketch_matrix(2000, 512, random_state=seed)
            Ys = Y @ Omega.toarray()
            norms.append(np.linalg.norm(Ys) / np.linalg.norm(Y))
        assert 0.5 < np.mean(norms) < 2.0


class TestSketchData:
    @pytest.mark.parametrize("method", ["countsketch", "rademacher"])
    def test_pipeline(self, method):
        rng = np.random.RandomState(0)
        Y = rng.rand(30, 90)
        X = rng.rand(4, 90)
        Ys, Xs, Omega = sketch_data(
            Y, X, sketch_dim=16, method=method, random_state=0
        )
        assert Ys.shape == (30, 16)
        assert Xs.shape == (4, 16)
        assert Omega.shape == (90, 16)

    def test_unknown_method(self):
        with pytest.raises(ValueError, match="Unknown sketching method"):
            sketch_data(np.zeros((3, 5)), np.zeros((2, 5)), 4, method="bogus")

    def test_unknown_backend(self):
        """A typo'd backend must raise, not silently take the host path."""
        with pytest.raises(ValueError, match="Unknown backend"):
            sketch_data(
                np.zeros((3, 5)), np.zeros((2, 5)), 4, backend="devcie"
            )

    def test_host_device_paths_agree(self):
        rng = np.random.RandomState(4)
        Y = rng.rand(25, 70)
        X = rng.rand(3, 70)
        Ys_h, Xs_h, _ = sketch_data(Y, X, 16, random_state=0, backend="host")
        Ys_d, Xs_d, _ = sketch_data(Y, X, 16, random_state=0, backend="device")
        np.testing.assert_allclose(Ys_d, Ys_h, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(Xs_d, Xs_h, rtol=1e-5, atol=1e-5)
