"""FlashDeconv orchestrator — the primary array-level API.

Runs the six-stage pipeline (reference ``flashdeconv/core/deconv.py:237-405``):
gene selection -> preprocessing -> CountSketch -> spatial graph -> lambda
auto-tune -> BCD solve. Stages 1-5 are O(nnz)/O(N log N) host passes; stage 6
is the device-resident while-loop solve. Constructor parameters, validation
behavior, and fitted attributes (`beta_`, `proportions_`, `gene_idx_`,
`info_`, `lambda_used_`, `adjacency_`) match the reference contract.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
from scipy import sparse

ArrayLike = Union[np.ndarray, sparse.spmatrix]

_PREPROCESS_METHODS = ("log_cpm", "pearson", "raw")


def _log_cpm_dense(X: np.ndarray) -> np.ndarray:
    """Dense log1p(CPM*1e4) with the signature-matrix epsilon convention."""
    Xd = np.asarray(X, dtype=np.float64)
    return np.log1p(Xd / (Xd.sum(axis=1, keepdims=True) + 1e-10) * 1e4)


#: NB overdispersion for the pearson-residual preprocess (reference
#: flashdeconv/core/deconv.py:199-225 hard-codes theta=100).
_PEARSON_THETA = 100.0


def _pearson_sigma(mu: np.ndarray) -> np.ndarray:
    """NB standard deviation sqrt(mu + mu^2/theta) in mu's dtype — the ONE
    home of the formula so the staged and fused pearson paths cannot
    drift."""
    return np.sqrt(mu + mu**2 / _PEARSON_THETA)


def _pearson_dense(X: np.ndarray) -> np.ndarray:
    """Dense uncentered Pearson residuals (the signature-matrix branch)."""
    Xd = np.asarray(X, dtype=np.float64)
    mu_x = Xd.mean(axis=0, keepdims=True) + 1e-6
    return Xd / _pearson_sigma(mu_x)


def _zero_poisoned_csr_rows(Y, gene_idx: np.ndarray, logcpm: bool = False):
    """Rows of CSR ``Y`` whose *selected* gene entries poison the fused
    feed, zeroed in a data-only copy; None when nothing needs repair.

    Support for the fused-feed degraded path: the native pass reduces YtY
    over the raw sketch, so one poisoned count makes the objective
    constant non-finite even though the solver's row guard keeps beta
    finite. Poison = a non-finite entry, or — on the log_cpm path
    (``logcpm=True``) — a finite entry whose log1p(v * 1e4/lib) is
    non-finite (``v * scale <= -1``; ``lib`` = the row's SELECTED-gene
    sum with the staged path's lib==0 -> 1 rule, so the exact rows the
    staged pipeline's sketch-level guard would zero). A poisoned log_cpm
    row necessarily contains a negative or non-finite selected entry
    (all-nonnegative-finite rows give scale > 0 and v*scale >= 0), so
    candidates are found cheaply and verified exactly per row.
    Only selected columns matter — the fused kernels subset genes before
    the library-size/normalize/sketch passes (reference
    ``flashdeconv/core/deconv.py:321-330`` subsets first too). The whole
    poisoned row is zeroed (not just the bad entry) to match the solver
    guard's zero-observation semantics.
    """
    sel = np.zeros(Y.shape[1], dtype=bool)
    sel[np.asarray(gene_idx)] = True
    data = Y.data
    cand_entry = ~np.isfinite(data)
    if logcpm:
        cand_entry |= data < 0
    cand_pos = np.flatnonzero(cand_entry)
    if cand_pos.size:
        cand_pos = cand_pos[sel[Y.indices[cand_pos]]]
    if cand_pos.size == 0:
        return None
    cand_rows = np.unique(
        np.searchsorted(Y.indptr, cand_pos, side="right") - 1
    )
    bad_rows = []
    for r in cand_rows:
        lo, hi = Y.indptr[r], Y.indptr[r + 1]
        v = data[lo:hi][sel[Y.indices[lo:hi]]]
        if not np.isfinite(v).all():
            bad_rows.append(r)
            continue
        if logcpm:
            lib = float(v.sum())
            if lib == 0.0:
                lib = 1.0
            if np.any(v * (1e4 / lib) <= -1.0):
                bad_rows.append(r)
    if not bad_rows:
        return None
    data = data.copy()
    for r in bad_rows:
        data[Y.indptr[r]: Y.indptr[r + 1]] = 0.0
    return sparse.csr_matrix((data, Y.indices, Y.indptr), shape=Y.shape)


def preprocess_data(
    Y: ArrayLike,
    X: np.ndarray,
    method: str = "log_cpm",
) -> Tuple[ArrayLike, np.ndarray]:
    """Normalize spatial counts Y and signatures X.

    Methods
    -------
    log_cpm : log1p(counts-per-10k). Sparse Y keeps its sparsity pattern
        (log1p(0)=0): only the ``.data`` values change, returned as a new
        CSR matrix; the input is never modified.
    pearson : uncentered Pearson residuals y / sigma with the NB variance
        model sigma^2 = mu + mu^2/theta (theta=100); keeps values >= 0.
    raw : float cast only.
    """
    if method == "log_cpm":
        if sparse.issparse(Y):
            from flashdeconv_tpu import native

            Ycsr = Y.tocsr() if not sparse.isspmatrix_csr(Y) else Y
            lib = native.csr_row_sums(Ycsr)
            if lib is None:
                lib = np.asarray(Ycsr.sum(axis=1)).ravel()
            lib[lib == 0] = 1.0
            # Direct per-nnz transform: avoids the diagonal matmul (which
            # dominates at atlas-scale nnz). Index arrays are copied so the
            # returned matrix never aliases the caller's buffers (an
            # in-place structural op like sort_indices() on the result must
            # not corrupt the input). Native kernel when available
            # (threaded, element-wise; <= 1 ULP of the numpy expression —
            # see native.exact_log1p_available); numpy otherwise.
            # scale dtype follows numpy promotion: f32 data keeps the f32
            # library sizes (scipy's .sum semantics), anything else is f64.
            scale = 1e4 / np.asarray(lib, dtype=np.float64) \
                if Ycsr.data.dtype != np.float32 else 1e4 / lib.astype(
                    np.float32, copy=False)
            new_data = native.log1p_cpm_transform(Ycsr, scale)
            if new_data is None:
                counts = np.diff(Ycsr.indptr)
                new_data = np.log1p(Ycsr.data * np.repeat(scale, counts))
            Y_norm = sparse.csr_matrix(
                (new_data, Ycsr.indices.copy(), Ycsr.indptr.copy()),
                shape=Ycsr.shape, copy=False,
            )
        else:
            Yd = np.asarray(Y, dtype=np.float64)
            Y_norm = np.log1p(Yd / (Yd.sum(axis=1, keepdims=True) + 1e-10) * 1e4)
        return Y_norm, _log_cpm_dense(X)

    if method == "pearson":
        if sparse.issparse(Y):
            mu = np.asarray(Y.mean(axis=0)).ravel() + 1e-6
            Y_norm = Y.multiply(1.0 / _pearson_sigma(mu)).tocsr()
        else:
            Yd = np.asarray(Y, dtype=np.float64)
            mu = Yd.mean(axis=0, keepdims=True) + 1e-6
            Y_norm = Yd / _pearson_sigma(mu)
        return Y_norm, _pearson_dense(X)

    if method == "raw":
        return Y.astype(np.float64, copy=False), X.astype(np.float64, copy=False)

    raise ValueError(
        f"Unknown preprocess method: {method}. "
        f"Choose from 'log_cpm', 'pearson', or 'raw'."
    )


class FlashDeconv:
    """Fast spatial-transcriptomics deconvolution with spatial regularization.

    Estimates per-spot cell-type proportions from a spatial count matrix and
    a reference signature matrix by solving a graph-regularized non-negative
    least-squares problem in a CountSketch-compressed gene space.

    Parameters
    ----------
    sketch_dim : int, default 512
        Dimension of the sketched gene space.
    lambda_spatial : float or "auto", default "auto"
        Spatial smoothing strength; "auto" scales to the data
        (see :func:`flashdeconv_tpu.core.spatial.auto_tune_lambda`).
    rho_sparsity : float, default 0.01
        Dimensionless L1 penalty (rescaled by mean(diag(XtX)) internally).
    n_hvg : int, default 2000
        Highly variable genes to select from the spatial data.
    n_markers_per_type : int, default 50
        Marker genes per cell type from the reference.
    spatial_method : {"knn", "radius", "grid"}, default "knn"
    k_neighbors : int, default 6
        Neighbors for the kNN graph.
    radius : float, optional
        Required when ``spatial_method="radius"``.
    max_iter : int, default 100
    tol : float, default 1e-4
    preprocess : {"log_cpm", "pearson", "raw"}, default "log_cpm"
    random_state : int, optional, default 0
    verbose : bool, default False
    solver_dtype : numpy dtype, default float32
        Device compute precision for the BCD solve.
    mesh : jax.sharding.Mesh, optional
        Device mesh for the spot-sharded distributed solve; when given (or
        when ``n_shards > 1``) stage 6 runs via
        :func:`flashdeconv_tpu.parallel.sharded_bcd_solve`.
    n_shards : int, optional
        Number of local devices to shard spots over (builds a 1-D mesh).
    warm_start : bool, default False
        Reuse the previous fit's ``beta_`` as the solver's starting point
        when shapes match (useful for re-fits with perturbed data or
        hyperparameters; reference always cold-starts).

    Attributes (after fit)
    ----------------------
    beta_ : (n_spots, n_cell_types) raw abundances
    proportions_ : row-normalized proportions
    gene_idx_ : selected gene indices
    info_ : solver convergence info
    lambda_used_ : resolved spatial regularization value
    adjacency_ : scipy CSR spatial graph
    """

    def __init__(
        self,
        sketch_dim: int = 512,
        lambda_spatial: Union[float, str] = "auto",
        rho_sparsity: float = 0.01,
        n_hvg: int = 2000,
        n_markers_per_type: int = 50,
        spatial_method: str = "knn",
        k_neighbors: int = 6,
        radius: Optional[float] = None,
        max_iter: int = 100,
        tol: float = 1e-4,
        preprocess: str = "log_cpm",
        random_state: Optional[int] = 0,
        verbose: bool = False,
        solver_dtype=np.float32,
        mesh=None,
        n_shards: Optional[int] = None,
        warm_start: bool = False,
        device_outputs: Optional[bool] = None,
        fetch_dtype=None,
        outputs: Tuple[str, ...] = ("proportions",),
    ):
        if sketch_dim <= 0:
            raise ValueError(f"sketch_dim must be positive, got {sketch_dim}")
        if k_neighbors < 0:
            raise ValueError(f"k_neighbors must be non-negative, got {k_neighbors}")
        if max_iter < 0:
            raise ValueError(f"max_iter must be non-negative, got {max_iter}")
        if tol <= 0:
            raise ValueError(f"tol must be positive, got {tol}")
        if isinstance(lambda_spatial, (int, float)) and lambda_spatial < 0:
            raise ValueError(
                f"lambda_spatial must be non-negative, got {lambda_spatial}"
            )
        if rho_sparsity < 0:
            raise ValueError(f"rho_sparsity must be non-negative, got {rho_sparsity}")
        if n_hvg < 0:
            raise ValueError(f"n_hvg must be non-negative, got {n_hvg}")
        if n_markers_per_type < 0:
            raise ValueError(
                f"n_markers_per_type must be non-negative, got {n_markers_per_type}"
            )
        if spatial_method == "radius" and radius is None:
            raise ValueError("radius must be specified when spatial_method='radius'")
        if radius is not None and radius <= 0:
            raise ValueError(f"radius must be positive, got {radius}")
        if preprocess not in _PREPROCESS_METHODS:
            raise ValueError(
                f"Unknown preprocess method: {preprocess}. "
                f"Choose from {_PREPROCESS_METHODS}."
            )
        if n_shards is not None and n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if fetch_dtype is not None:
            fetch_dtype = str(
                fetch_dtype if isinstance(fetch_dtype, str)
                else np.dtype(fetch_dtype).name
            )
            if fetch_dtype not in ("float16", "bfloat16", "float32"):
                raise ValueError(
                    "fetch_dtype must be one of None, 'float16', "
                    f"'bfloat16', 'float32'; got {fetch_dtype!r}"
                )
        outputs = tuple(outputs)
        if not outputs or not set(outputs) <= {"proportions", "dominant"}:
            raise ValueError(
                "outputs must be a non-empty subset of "
                f"('proportions', 'dominant'); got {outputs!r}"
            )

        self.sketch_dim = sketch_dim
        self.lambda_spatial = lambda_spatial
        self.rho_sparsity = rho_sparsity
        self.n_hvg = n_hvg
        self.n_markers_per_type = n_markers_per_type
        self.spatial_method = spatial_method
        self.k_neighbors = k_neighbors
        self.radius = radius
        self.max_iter = max_iter
        self.tol = tol
        self.preprocess = preprocess
        self.random_state = random_state
        self.verbose = verbose
        self.solver_dtype = solver_dtype
        self.mesh = mesh
        self.n_shards = n_shards
        self.warm_start = warm_start
        # None = auto: keep the solve output on its device (and fetch
        # f32 proportions directly) when fitting on an accelerator
        # single-device path; False = always fetch + normalize on host
        # (the reference-exact f64 post-processing); True = force the
        # device path even on CPU and on (single-process) sharded meshes
        # — multi-process jobs always take the gathered host path, since
        # no single process can device_get the global array.
        self.device_outputs = device_outputs
        # Device->host payload controls (~80 MB of f32 proportions at
        # 1M x 20):
        # fetch_dtype="float16"/"bfloat16" halves the proportions payload
        # (values quantized to ~5e-4 relative — proportions are in [0, 1],
        # well inside f16 range); outputs=("dominant",) fetches only the
        # device-computed argmax as uint8 (~1 MB at 1M spots, 80x less),
        # leaving proportions device-resident for lazy access. Both only
        # apply on the device-outputs path.
        self.fetch_dtype = fetch_dtype
        self.outputs = outputs

        self.beta_ = None
        self.proportions_ = None
        self.dominant_ = None
        self.gene_idx_ = None
        self.info_ = None
        self.timings_ = None
        self._fitted = False

    # Kept as a method for API familiarity; delegates to the module function.
    def _preprocess_data(self, Y, X, method):
        return preprocess_data(Y, X, method)

    def _pipeline_operands(
        self,
        Y: ArrayLike,
        X: np.ndarray,
        coords: np.ndarray,
        cell_type_names: Optional[np.ndarray],
        timer,
    ):
        """Stages 1-4 (validation, gene selection, normalization, sketch,
        graph); shared by :meth:`fit` and :meth:`fit_lambda_path`."""
        from flashdeconv_tpu.core.sketching import sketch_data
        from flashdeconv_tpu.utils.genes import select_informative_genes
        from flashdeconv_tpu.utils.graph import coords_to_adjacency
        from flashdeconv_tpu.utils.timing import trace

        if sparse.issparse(Y) and not sparse.isspmatrix_csr(Y):
            # COO/DIA/BSR don't support the column subsetting below.
            Y = Y.tocsr()
        if Y.shape[1] != X.shape[1]:
            raise ValueError(
                f"Gene dimension mismatch: Y has {Y.shape[1]} genes but "
                f"X has {X.shape[1]} genes. They must share the same gene "
                f"space (align before calling fit)."
            )
        if coords.shape[0] != Y.shape[0]:
            raise ValueError(
                f"Spot count mismatch: Y has {Y.shape[0]} spots but "
                f"coords has {coords.shape[0]} rows. Each spot needs "
                f"exactly one coordinate."
            )
        if X.shape[0] == 0:
            raise ValueError(
                "Reference matrix X must contain at least one cell type "
                "(X.shape[0] > 0). Check your reference filtering and "
                "cell_type_key mapping."
            )
        if cell_type_names is not None and len(cell_type_names) != X.shape[0]:
            raise ValueError(
                f"cell_type_names length ({len(cell_type_names)}) does not "
                f"match number of cell types in X ({X.shape[0]})."
            )

        self._log("FlashDeconv: starting deconvolution...")
        self._log(f"  Spatial data: {Y.shape[0]} spots x {Y.shape[1]} genes")
        self._log(f"  Reference: {X.shape[0]} cell types x {X.shape[1]} genes")

        self.n_spots_ = Y.shape[0]
        self.n_genes_ = Y.shape[1]
        self.n_cell_types_ = X.shape[0]
        self.cell_type_names_ = cell_type_names

        # Clear any consume-once state a previously aborted fit left behind
        # (these describe THAT fit's operands, not this one's).
        self._clear_consume_once()

        # [4, started early] spatial graph on a background thread: the
        # KD-tree build/query depends only on coords, so it overlaps the
        # gene-selection / preprocessing / sketching passes over Y (scipy
        # releases the GIL). Joined — and any validation error re-raised —
        # at the stage-4 position below, preserving error semantics.
        import concurrent.futures as _cf

        graph_pool = _cf.ThreadPoolExecutor(2)
        graph_future = graph_pool.submit(
            coords_to_adjacency, coords, method=self.spatial_method,
            k=self.k_neighbors, radius=self.radius,
        )
        # Chain the banded-vs-gather analysis onto the graph future
        # IMMEDIATELY (second pool thread blocks until the graph is ready,
        # then decomposes) so its ~1 s O(nnz) pass overlaps the sketch
        # stage instead of landing in the solve stage's wall-clock; the
        # solver joins it inside prepare. On a graph-build error the plan
        # future carries the same exception, which stage 4 re-raises from
        # graph_future first (the plan future's copy stays unobserved by
        # design).
        if not self._is_sharded:
            from flashdeconv_tpu.core.solver import GraphDecomposition

            self._graph_plan_future = graph_pool.submit(
                lambda: GraphDecomposition(
                    graph_future.result(), Y.shape[0], coords
                )
            )
        else:
            self._graph_plan_future = None
        graph_pool.shutdown(wait=False)

        from flashdeconv_tpu import native

        # Fused stage-1..3 fast path for the canonical sparse pipeline
        # (CSR counts + log_cpm + CountSketch): ONE native O(nnz) pass
        # computes subset library sizes, log-CPM values, and the sketch
        # scatter without materializing the subset CSR or the normalized
        # copy — bit-identical to the staged NATIVE path by construction
        # (see native/host_kernels.cpp fused_log1pcpm_project_impl), within
        # 1 ULP per log1p value of the pure-numpy path (the libm gate in
        # native._load()).
        # native.fused_available / native.colscale_available are the
        # kernels' own authoritative gates (CSR + float dtype; the log_cpm
        # family additionally needs the per-dtype libm self-test), so the
        # only pipeline-side condition is the preprocessing mode. A None
        # from the fused kernels below is therefore gate drift — an
        # internal error, not a runtime fallback.
        #
        # pearson / raw reduce to a per-gene column scale (pearson:
        # 1/sigma from the subset column means; raw: identity), so they
        # share one fused subset->scale->sketch kernel family — unlike the
        # log_cpm kernels it contains no libm and is bit-identical to the
        # staged scipy pipeline.
        if self.preprocess == "log_cpm":
            use_fused = native.fused_available(Y)
        else:
            use_fused = native.colscale_available(Y)

        try:
            # [1] informative genes + leverage
            self._log("Step 1: selecting informative genes...")
            with timer.stage("gene_selection"):
                gene_idx, leverage_scores = select_informative_genes(
                    Y, X, n_hvg=self.n_hvg,
                    n_markers_per_type=self.n_markers_per_type,
                )
                self.gene_idx_ = gene_idx
                X_subset = X[:, gene_idx]
                Y_subset = None
                if not use_fused and sparse.isspmatrix_csr(Y):
                    # Threaded native column subset (bit-identical to
                    # scipy's fancy indexing, which runs as a
                    # selection-matrix matmul and dominates this stage at
                    # atlas-scale nnz).
                    Y_subset = native.csr_column_subset(Y, gene_idx)
                if not use_fused and Y_subset is None:
                    Y_subset = Y[:, gene_idx]
                    if sparse.issparse(Y_subset) and not sparse.isspmatrix_csr(
                        Y_subset
                    ):
                        Y_subset = Y_subset.tocsr()
            self._log(f"  Selected {len(gene_idx)} genes (HVG + markers)")

            # [2] normalization
            self._log(
                f"Step 2: preprocessing with method='{self.preprocess}'..."
            )
            colscale = None
            with timer.stage("preprocess"):
                if use_fused and self.preprocess == "log_cpm":
                    X_tilde = _log_cpm_dense(X_subset)  # Y: stage 3
                elif use_fused and self.preprocess == "pearson":
                    # Subset column means without materializing the subset
                    # (bit-identical to Y[:, gene_idx].mean(axis=0)); the
                    # Y normalization itself becomes the fused kernel's
                    # per-gene scale in stage 3. Dtype promotions mirror
                    # preprocess_data exactly: mu keeps the data dtype
                    # (+1e-6 does not promote f32 under NumPy 2), so
                    # sigma and 1/sigma match the staged path bitwise.
                    mu = native.subset_col_mean(Y, gene_idx)
                    if mu is None:
                        raise RuntimeError(
                            "subset_col_mean returned None despite "
                            "colscale_available passing — native gate drift"
                        )
                    mu = mu + 1e-6
                    colscale = 1.0 / _pearson_sigma(mu)
                    X_tilde = _pearson_dense(X_subset)
                elif use_fused:  # raw
                    X_tilde = X_subset.astype(np.float64, copy=False)
                else:
                    Y_tilde, X_tilde = preprocess_data(
                        Y_subset, X_subset, self.preprocess
                    )

            # [3] sketch G_sel -> d
            self._log(f"Step 3: sketching to {self.sketch_dim} dimensions...")
            with timer.stage("sketch"), trace("sketch"):
                if use_fused:
                    from flashdeconv_tpu.core.sketching import (
                        make_countsketch_op,
                    )

                    op = make_countsketch_op(
                        len(gene_idx), self.sketch_dim,
                        leverage_scores=leverage_scores,
                        random_state=self.random_state,
                    )
                    X_sketch = np.asarray(X_tilde @ op.to_csr())
                    # Every solver (single-device and both sharded
                    # strategies) consumes the (N, d) sketch only through
                    # Xty = Y_sketch @ X_sketch.T and the YtY Frobenius
                    # constant — contract row-wise inside the kernel and
                    # never materialize the sketch (multi-GB at atlas
                    # scale).
                    res = self._fused_xty_feed(
                        Y, gene_idx, op, X_sketch, colscale=colscale
                    )
                    if res is None:
                        # use_fused is the kernel family's own gate
                        # (fused_available / colscale_available); a None
                        # here is gate drift — a bug, not a runtime
                        # condition.
                        raise RuntimeError(
                            "fused xty kernel returned None despite "
                            "its gates passing — native gate drift"
                        )
                    if not np.isfinite(res[1]):
                        # Degraded path: poisoned counts (non-finite, or
                        # negatives whose log1p goes non-finite) NaN'd
                        # the YtY reduction. The solver's row guard keeps
                        # beta finite regardless, but the objective
                        # constant must reflect the sanitized problem —
                        # see core.solver.sanitize_yty. Zero the poisoned
                        # rows in a data-only CSR copy and re-run the
                        # feed.
                        Y_rep = _zero_poisoned_csr_rows(
                            Y, gene_idx,
                            logcpm=self.preprocess == "log_cpm",
                        )
                        if Y_rep is not None:
                            # Release the poisoned streamed (N, K) device
                            # buffer BEFORE streaming the repaired one —
                            # holding both transiently doubles HBM for
                            # the solve's largest operand.
                            res = None
                            res = self._fused_xty_feed(
                                Y_rep, gene_idx, op, X_sketch,
                                colscale=colscale,
                            )
                            if res is None:
                                raise RuntimeError(
                                    "fused xty kernel returned None on "
                                    "the repaired input — native gate "
                                    "drift"
                                )
                    self._fused_xty, self._fused_yty = res
                    Y_sketch = None
                else:
                    Y_sketch, X_sketch, _ = sketch_data(
                        Y_tilde,
                        X_tilde,
                        sketch_dim=self.sketch_dim,
                        leverage_scores=leverage_scores,
                        random_state=self.random_state,
                    )
        except BaseException:
            # Fail fast without orphan work: best-effort cancel (a running
            # KD-tree build cannot be interrupted, but a queued one is
            # dropped and its eventual exception stays unobserved by
            # design — ours is the error the caller should see).
            graph_future.cancel()
            plan_f = self.__dict__.pop("_graph_plan_future", None)
            if plan_f is not None:
                plan_f.cancel()
            raise

        # [4] spatial graph (join the early-started build; the recorded
        # stage time is the residual wait, i.e. what the graph actually
        # adds to the pipeline's wall-clock). The banded-vs-gather plan
        # future was chained onto the same pool above.
        self._log("Step 4: building spatial graph...")
        with timer.stage("spatial_graph"):
            A = graph_future.result()
        self.adjacency_ = A
        avg_nbrs = float(np.mean(np.asarray(A.sum(axis=1)).ravel()))
        self._log(f"  Average neighbors per spot: {avg_nbrs:.1f}")
        return Y_sketch, X_sketch, A

    def _resolve_lambda(self, Y_sketch, X_sketch, A, timer) -> float:
        from flashdeconv_tpu.core.spatial import auto_tune_lambda

        with timer.stage("lambda_tuning"):
            if self.lambda_spatial == "auto":
                lambda_ = auto_tune_lambda(Y_sketch, X_sketch, A)
                self._log(f"Step 5: auto-tuned lambda = {lambda_:.4f}")
            else:
                lambda_ = float(self.lambda_spatial)
                self._log(f"Step 5: using lambda = {lambda_:.4f}")
        return lambda_

    def _fused_xty_feed(self, Y, gene_idx, op, X_sketch, colscale=None):
        """Compute (Xty, YtY) via the native fused sketch pass.

        Kernel family follows ``self.preprocess``: the log-CPM kernels for
        "log_cpm", the column-scale kernels for "pearson" (``colscale`` =
        1/sigma per subset gene) and "raw" (``colscale`` = None).

        Single-device accelerator fits stream the kernel in row chunks and
        enqueue each chunk's host->device transfer while the next chunk
        computes — the (N, K) upload hides behind the O(nnz) pass. Returns
        ``(xty, yty)`` with ``xty`` a device array on the streamed path,
        else a host (N, K) float64 array; None if the native kernel is
        unavailable.
        """
        import jax

        from flashdeconv_tpu import native

        if self.preprocess == "log_cpm":
            xty_full = lambda: native.fused_log1pcpm_xty(  # noqa: E731
                Y, gene_idx, op.buckets, op.weights, op.sketch_dim, X_sketch,
            )
            xty_chunks = lambda rows: native.fused_log1pcpm_xty_chunks(  # noqa: E731,E501
                Y, gene_idx, op.buckets, op.weights, op.sketch_dim,
                X_sketch, chunk_rows=rows,
            )
        else:
            xty_full = lambda: native.fused_colscale_xty(  # noqa: E731
                Y, gene_idx, colscale, op.buckets, op.weights,
                op.sketch_dim, X_sketch,
            )
            xty_chunks = lambda rows: native.fused_colscale_xty_chunks(  # noqa: E731,E501
                Y, gene_idx, colscale, op.buckets, op.weights,
                op.sketch_dim, X_sketch, chunk_rows=rows,
            )

        chunk_rows = native.XTY_STREAM_CHUNK_ROWS
        if (
            not self._is_sharded
            and jax.default_backend() != "cpu"
            and Y.shape[0] > chunk_rows
        ):
            chunks = xty_chunks(chunk_rows)
            if chunks is None:
                return None
            import jax.numpy as jnp

            parts, yty = [], 0.0
            for _, _, xty_np, yty_part in chunks:
                parts.append(
                    jnp.asarray(np.asarray(xty_np, dtype=self.solver_dtype))
                )
                yty += yty_part
            return jnp.concatenate(parts, axis=0), yty
        return xty_full()

    def _solve(self, Y_sketch, X_sketch, A, coords, lambda_, beta_init,
               return_device: bool = False):
        """Stage-6 dispatch: single-device vs spot-sharded mesh solve."""
        from flashdeconv_tpu.core.solver import bcd_solve

        if self._is_sharded:
            from flashdeconv_tpu.parallel import prepare_sharded_bcd

            self._log(
                "Step 6: solving via sharded Block Coordinate Descent "
                "(spot-parallel mesh)..."
            )
            problem = prepare_sharded_bcd(
                Y_sketch, X_sketch, A,
                coords=coords, mesh=self.mesh, n_shards=self.n_shards,
                dtype=self.solver_dtype, verbose=self.verbose,
                # Consume-once fused-kernel reductions (set when the
                # pipeline never materialized the sketch); the sharded
                # solvers, like the single-device one, consume the sketch
                # only through these.
                xty=self.__dict__.pop("_fused_xty", None),
                yty=self.__dict__.pop("_fused_yty", None),
            )
            return problem.solve(
                lambda_=lambda_, rho=self.rho_sparsity,
                max_iter=self.max_iter, tol=self.tol,
                verbose=self.verbose, beta_init=beta_init,
                return_device=return_device,
            )
        self._log("Step 6: solving via Block Coordinate Descent on device...")
        return bcd_solve(
            Y_sketch, X_sketch, A,
            lambda_=lambda_, rho=self.rho_sparsity,
            max_iter=self.max_iter, tol=self.tol,
            verbose=self.verbose, dtype=self.solver_dtype,
            beta_init=beta_init, coords=coords,
            # a Future when the pipeline pre-analyzed the graph on a
            # background thread; the solver joins it after dispatching
            # the Xty upload. Popped (consume-once) so the plan's banded
            # masks / re-sorted adjacency don't outlive the solve on the
            # model instance. Same for the fused-kernel Xty/YtY (set when
            # the pipeline never materialized the sketch).
            graph_plan=self.__dict__.pop("_graph_plan_future", None),
            xty=self.__dict__.pop("_fused_xty", None),
            yty=self.__dict__.pop("_fused_yty", None),
            return_device=return_device,
        )

    def fit(
        self,
        Y: ArrayLike,
        X: np.ndarray,
        coords: np.ndarray,
        cell_type_names: Optional[np.ndarray] = None,
    ) -> "FlashDeconv":
        """Run the full pipeline; stores results on the instance."""
        from flashdeconv_tpu.core.solver import normalize_proportions
        from flashdeconv_tpu.utils.timing import StageTimer, trace

        timer = StageTimer()
        try:
            Y_sketch, X_sketch, A = self._pipeline_operands(
                Y, X, coords, cell_type_names, timer
            )
            lambda_ = self._resolve_lambda(Y_sketch, X_sketch, A, timer)
            self.lambda_used_ = lambda_

            beta_init = None
            if (
                self.warm_start
                and self.beta_ is not None
                and self.beta_.shape == (Y.shape[0], X.shape[0])
            ):
                beta_init = self.beta_
                self._log("  Warm-starting from previous beta_")

            # Device-outputs path: leave beta on its device, normalize
            # there, fetch only the f32 proportions (the host f64 convert
            # + normalize pass disappears; beta_ fetches lazily on first
            # access). auto (None) = on for non-sharded accelerator fits.
            # The sharded solvers support return_device on single-process
            # meshes (a multi-process global array is not device_get-able
            # from one process, so multihost jobs take the gathered host
            # path). auto (None) keeps sharded fits on the host path —
            # shard-count-invariance consumers usually want host f64 —
            # but an explicit True is honored.
            import jax

            single_proc = jax.process_count() == 1
            device_out = self.device_outputs
            if device_out is None:
                device_out = (
                    not self._is_sharded and jax.default_backend() != "cpu"
                )
            else:
                device_out = bool(device_out) and single_proc

            # [6] solve — multi-device when a mesh/shard count configured
            with timer.stage("solve"), trace("bcd_solve"):
                beta, info = self._solve(
                    Y_sketch, X_sketch, A, coords, lambda_, beta_init,
                    return_device=device_out,
                )
                props = props_dev = dominant = None
                if device_out:
                    import jax
                    import jax.numpy as jnp

                    from flashdeconv_tpu.core.solver import (
                        normalize_proportions_device,
                    )

                    props_dev = normalize_proportions_device(beta)
                    # Assemble the wire payload on device, then fetch it
                    # in ONE bundled device_get: the f32 proportions by
                    # default, narrowed by fetch_dtype on request, or just
                    # the uint8 argmax when only the dominant type is
                    # wanted (80x less payload at 1M x 20).
                    fetches = {}
                    if "proportions" in self.outputs:
                        fetches["props"] = self._fetch_cast(props_dev)
                    if "dominant" in self.outputs:
                        dom_dt = (
                            jnp.uint8 if beta.shape[1] <= 256 else jnp.int32
                        )
                        fetches["dominant"] = jnp.argmax(
                            props_dev, axis=1
                        ).astype(dom_dt)
                    got = jax.device_get(fetches)
                    if "props" in got:
                        props = np.asarray(got["props"], dtype=np.float64)
                        props_dev = None
                    dominant = got.get("dominant")
        except BaseException:
            # Don't let a failed fit pin the consume-once operands — on
            # the streamed path _fused_xty is an (N, K) DEVICE buffer
            # (~800 MB of HBM at 10M spots).
            self._clear_consume_once()
            raise

        if device_out:
            self._beta_host = None if not isinstance(beta, np.ndarray) else beta
            self._beta_dev = None if isinstance(beta, np.ndarray) else beta
            self._props_host = props
            self._props_dev = props_dev
            self.dominant_ = (
                None if dominant is None
                else np.asarray(dominant, dtype=np.int64)
            )
        else:
            self.beta_ = beta
            self.proportions_ = normalize_proportions(beta)
            self.dominant_ = None
        self.info_ = info
        self.timings_ = timer.timings
        self._fitted = True

        self._log(f"  Converged: {info['converged']}")
        self._log(f"  Iterations: {info['n_iterations']}")
        if self.verbose:
            print("Stage timings:")
            print(timer.report())
        self._log("FlashDeconv: done!")
        return self

    def fit_transform(
        self,
        Y: ArrayLike,
        X: np.ndarray,
        coords: np.ndarray,
        **kwargs,
    ) -> np.ndarray:
        """Fit and return the (n_spots, n_cell_types) proportion matrix."""
        self.fit(Y, X, coords, **kwargs)
        return self.proportions_

    def fit_distributed(
        self,
        Y_local: ArrayLike,
        X: np.ndarray,
        coords_local: np.ndarray,
        cell_type_names: Optional[np.ndarray] = None,
    ) -> "FlashDeconv":
        """One-call multi-host fit: every process passes only its spot slice.

        Run the SAME script on every process of a ``jax.distributed`` job
        (after :func:`flashdeconv_tpu.parallel.multihost.initialize`), with
        ``Y_local`` / ``coords_local`` holding process p's contiguous block
        of global spot rows (process 0's rows first, then process 1's, ...).
        The full spatial count matrix — the only atlas-scale operand — never
        exists on any single host; per stage:

        1. gene selection — per-host O(local nnz) HVG moment passes, one
           cross-host reduction (``distributed_select_informative_genes``);
        2. normalization + sketch + Xty feed — per-host fused native pass
           over the local CSR slice (log-CPM is row-local; pearson's global
           gene means are one ``allreduce``); only the (N, K) Xty rows are
           exchanged;
        3. spatial graph — coordinates (16 B/spot) are all-gathered once,
           each host runs the kNN *queries* for its own rows, and the
           directed edge lists are exchanged + symmetrized
           (:func:`flashdeconv_tpu.parallel.multihost.distributed_knn_graph`);
        4. lambda auto-tune — replicated closed form (global XtX diagonal +
           all-gathered graph degrees);
        5. solve — the spot-sharded mesh solve over all devices in the job
           (each process materializes only its devices' shards; per-sweep
           halos ride the device/process interconnect), gathered back so every
           process ends with the identical fitted state.

        The result is bit-identical to single-process :meth:`fit` on the
        concatenated inputs with the same global device mesh when the
        canonical native fused path applies (CSR counts + ``log_cpm``, the
        default); pearson/raw and non-native fallbacks agree to float64
        rounding (cross-host sums reassociate). ``device_outputs`` /
        ``fetch_dtype`` / ``outputs`` are ignored here: no single process
        can fetch the global device array, so the host f64 path runs.

        Replicated per-host state is O(N) metadata only — coordinates,
        adjacency, and the (N, K) Xty — a few hundred MB at 10M spots
        versus the tens-of-GB count matrix that stays sliced.

        Single-process calls degrade to the sharded :meth:`fit` semantics
        over all local devices (useful for testing the code path).
        """
        from flashdeconv_tpu.core.sketching import make_countsketch_op
        from flashdeconv_tpu.core.solver import normalize_proportions
        from flashdeconv_tpu.core.spatial import auto_tune_lambda
        from flashdeconv_tpu.parallel import multihost, prepare_sharded_bcd
        from flashdeconv_tpu.utils.timing import StageTimer, trace
        from flashdeconv_tpu import native

        timer = StageTimer()

        if sparse.issparse(Y_local) and not sparse.isspmatrix_csr(Y_local):
            Y_local = Y_local.tocsr()
        coords_local = np.asarray(coords_local, dtype=np.float64)
        if Y_local.shape[1] != X.shape[1]:
            raise ValueError(
                f"Gene dimension mismatch: Y has {Y_local.shape[1]} genes "
                f"but X has {X.shape[1]} genes. They must share the same "
                f"gene space (align before calling fit)."
            )
        if coords_local.shape[0] != Y_local.shape[0]:
            raise ValueError(
                f"Spot count mismatch: Y has {Y_local.shape[0]} spots but "
                f"coords has {coords_local.shape[0]} rows. Each spot needs "
                f"exactly one coordinate."
            )
        if X.shape[0] == 0:
            raise ValueError(
                "Reference matrix X must contain at least one cell type "
                "(X.shape[0] > 0). Check your reference filtering and "
                "cell_type_key mapping."
            )
        if cell_type_names is not None and len(cell_type_names) != X.shape[0]:
            raise ValueError(
                f"cell_type_names length ({len(cell_type_names)}) does not "
                f"match number of cell types in X ({X.shape[0]})."
            )

        mesh = self.mesh if self.mesh is not None else (
            multihost.global_spot_mesh()
        )
        row_start, row_stop, n_global = multihost.process_row_offsets(
            Y_local.shape[0]
        )
        if n_global == 0:
            raise ValueError("fit_distributed requires at least one spot.")

        self._log("FlashDeconv: distributed deconvolution...")
        self._log(
            f"  This process: rows [{row_start}, {row_stop}) of "
            f"{n_global} global spots x {Y_local.shape[1]} genes"
        )
        self.n_spots_ = n_global
        self.n_genes_ = Y_local.shape[1]
        self.n_cell_types_ = X.shape[0]
        self.cell_type_names_ = cell_type_names
        self.host_rows_ = (row_start, row_stop)
        self._clear_consume_once()

        # NOTE: stages run strictly sequentially — every process must issue
        # the same collectives in the same order, so the single-host
        # pipeline's background-thread graph overlap does not apply here.

        # [1] distributed gene selection (one cross-host moment reduction).
        self._log("Step 1: selecting informative genes (distributed)...")
        with timer.stage("gene_selection"):
            gene_idx, leverage_scores = (
                multihost.distributed_select_informative_genes(
                    Y_local, X, n_hvg=self.n_hvg,
                    n_markers_per_type=self.n_markers_per_type,
                )
            )
        self.gene_idx_ = gene_idx
        self._log(f"  Selected {len(gene_idx)} genes (HVG + markers)")

        # [2] normalization of the replicated signature matrix; the Y side
        # is folded into the fused per-host sketch pass below.
        X_subset = X[:, gene_idx]
        colscale = None
        with timer.stage("preprocess"):
            if self.preprocess == "log_cpm":
                X_tilde = _log_cpm_dense(X_subset)
            elif self.preprocess == "pearson":
                mu = multihost.distributed_subset_col_mean(
                    Y_local, gene_idx
                ) + 1e-6
                colscale = 1.0 / _pearson_sigma(mu)
                X_tilde = _pearson_dense(X_subset)
            else:  # raw
                X_tilde = X_subset.astype(np.float64, copy=False)

        # [3] sketch + per-host Xty feed. The CountSketch operator is
        # seed-built identically on every host; each host contracts only
        # its own rows (fused native pass when available), and the (N, K)
        # rows are exchanged in one all-gather.
        self._log(f"Step 3: sketching to {self.sketch_dim} dimensions...")
        with timer.stage("sketch"), trace("sketch"):
            op = make_countsketch_op(
                len(gene_idx), self.sketch_dim,
                leverage_scores=leverage_scores,
                random_state=self.random_state,
            )
            X_sketch = np.asarray(X_tilde @ op.to_csr())
            res = None
            if Y_local.shape[0] > 0:
                if self.preprocess == "log_cpm" and native.fused_available(
                    Y_local
                ):
                    res = native.fused_log1pcpm_xty(
                        Y_local, gene_idx, op.buckets, op.weights,
                        op.sketch_dim, X_sketch,
                    )
                elif self.preprocess != "log_cpm" and (
                    native.colscale_available(Y_local)
                ):
                    res = native.fused_colscale_xty(
                        Y_local, gene_idx, colscale, op.buckets, op.weights,
                        op.sketch_dim, X_sketch,
                    )
            if res is not None and not np.isfinite(res[1]):
                # Same poisoned-YtY repair as single-process fit (its
                # absence here would make fit_distributed's objective NaN
                # where fit()'s is finite, breaking the bit-parity
                # contract between them): zero this host's poisoned rows
                # (row-local, so no cross-host coordination needed — a
                # clean host's repair scan finds nothing) and re-run the
                # local fused pass.
                Y_rep = _zero_poisoned_csr_rows(
                    Y_local, gene_idx,
                    logcpm=self.preprocess == "log_cpm",
                )
                if Y_rep is not None:
                    if self.preprocess == "log_cpm":
                        res = native.fused_log1pcpm_xty(
                            Y_rep, gene_idx, op.buckets, op.weights,
                            op.sketch_dim, X_sketch,
                        )
                    else:
                        res = native.fused_colscale_xty(
                            Y_rep, gene_idx, colscale, op.buckets,
                            op.weights, op.sketch_dim, X_sketch,
                        )
            if res is not None:
                xty_local, yty_local = res
            else:
                # Staged fallback (non-CSR / non-float inputs, or no native
                # library): subset + normalize rows locally, project, then
                # contract. Row-local like the fused pass; the GEMM's
                # blocking may reassociate, so parity vs the single-host
                # staged path is float64-rounding-level, not bitwise.
                Y_sub = Y_local[:, gene_idx]
                if sparse.issparse(Y_sub) and not sparse.isspmatrix_csr(
                    Y_sub
                ):
                    Y_sub = Y_sub.tocsr()
                if self.preprocess == "pearson":
                    if sparse.issparse(Y_sub):
                        Y_tilde = Y_sub.multiply(colscale).tocsr()
                    else:
                        Y_tilde = np.asarray(
                            Y_sub, dtype=np.float64
                        ) * colscale
                else:
                    Y_tilde, _ = preprocess_data(
                        Y_sub, X_subset, self.preprocess
                    )
                Omega = op.to_csr()
                Y_sk = Y_tilde @ Omega
                if sparse.issparse(Y_sk):
                    Y_sk = np.asarray(Y_sk.todense())
                Y_sk = np.asarray(Y_sk, dtype=np.float64)
                xty_local = Y_sk @ X_sketch.T
                from flashdeconv_tpu.core.solver import sanitize_yty

                yty_local = sanitize_yty(None, Y_sk)
            xty = multihost.allgather_rows(
                np.ascontiguousarray(xty_local, dtype=np.float64)
            )
            yty_parts = multihost.allgather_rows(
                np.asarray([yty_local], dtype=np.float64)
            )
            yty = float(np.sum(yty_parts))

        # [4] spatial graph: distributed kNN queries + edge exchange.
        self._log("Step 4: building spatial graph (distributed)...")
        with timer.stage("spatial_graph"):
            A, coords_global = multihost.distributed_adjacency(
                coords_local, method=self.spatial_method,
                k=self.k_neighbors, radius=self.radius,
            )
        self.adjacency_ = A
        avg_nbrs = float(np.mean(np.asarray(A.sum(axis=1)).ravel()))
        self._log(f"  Average neighbors per spot: {avg_nbrs:.1f}")

        # [5] lambda: closed form over replicated operands.
        with timer.stage("lambda_tuning"):
            if self.lambda_spatial == "auto":
                lambda_ = auto_tune_lambda(None, X_sketch, A)
                self._log(f"Step 5: auto-tuned lambda = {lambda_:.4f}")
            else:
                lambda_ = float(self.lambda_spatial)
                self._log(f"Step 5: using lambda = {lambda_:.4f}")
        self.lambda_used_ = lambda_

        beta_init = None
        if (
            self.warm_start
            and self.beta_ is not None
            and self.beta_.shape == (n_global, X.shape[0])
        ):
            beta_init = self.beta_  # global from the previous fit
            self._log("  Warm-starting from previous beta_")

        # [6] spot-sharded solve over the job's global mesh; beta gathers
        # back to every process (see parallel/_runner.py).
        self._log(
            "Step 6: solving via sharded Block Coordinate Descent "
            "(global mesh)..."
        )
        with timer.stage("solve"), trace("bcd_solve"):
            problem = prepare_sharded_bcd(
                None, X_sketch, A, coords=coords_global, mesh=mesh,
                dtype=self.solver_dtype, verbose=self.verbose,
                xty=xty, yty=yty,
            )
            beta, info = problem.solve(
                lambda_=lambda_, rho=self.rho_sparsity,
                max_iter=self.max_iter, tol=self.tol,
                verbose=self.verbose, beta_init=beta_init,
            )

        self.beta_ = beta
        self.proportions_ = normalize_proportions(beta)
        self.dominant_ = None
        self.info_ = info
        self.timings_ = timer.timings
        self._fitted = True
        self._log(f"  Converged: {info['converged']}")
        self._log(f"  Iterations: {info['n_iterations']}")
        self._log("FlashDeconv: done!")
        return self

    def fit_lambda_path(
        self,
        Y: ArrayLike,
        X: np.ndarray,
        coords: np.ndarray,
        lambdas: Optional[np.ndarray] = None,
        cell_type_names: Optional[np.ndarray] = None,
    ) -> list:
        """Solve along a path of spatial-regularization strengths.

        Runs the expensive pipeline stages (gene selection, normalization,
        sketch, graph) ONCE, prepares the solver operands on device ONCE
        (:func:`flashdeconv_tpu.core.solver.prepare_bcd`), then solves for
        each lambda in ascending order, warm-starting every solve from the
        previous lambda's abundances — each subsequent solve is device-only
        and typically converges in a fraction of the cold-start sweeps. The
        model is left fitted at the final lambda.

        Parameters
        ----------
        lambdas : optional ascending array of lambda values; default is the
            auto-tuned lambda scaled by [0.1, 0.3, 1, 3, 10].

        Returns
        -------
        list of dicts: {"lambda", "proportions", "beta", "info"} per value.

        The reference has no equivalent (its solver always cold-starts,
        reference ``flashdeconv/core/solver.py:372``); this is the
        warm-start extension suggested by its own design (SURVEY.md §5).
        """
        from flashdeconv_tpu.core.solver import normalize_proportions
        from flashdeconv_tpu.utils.timing import StageTimer, trace

        timer = StageTimer()
        try:
            Y_sketch, X_sketch, A = self._pipeline_operands(
                Y, X, coords, cell_type_names, timer
            )
            if lambdas is None:
                base = self._resolve_lambda(Y_sketch, X_sketch, A, timer)
                lambdas = base * np.array([0.1, 0.3, 1.0, 3.0, 10.0])
            lambdas = np.sort(np.asarray(lambdas, dtype=float))
            if lambdas.size == 0:
                raise ValueError("lambdas must be non-empty")
            if lambdas[0] < 0:
                raise ValueError(
                    f"lambdas must be non-negative, got min {lambdas[0]}"
                )

            sharded = self._is_sharded
            with timer.stage("solver_prepare"):
                if sharded:
                    # Mesh path gets the same prepare-once treatment:
                    # graph analysis / partition, host precompute, and
                    # device scatter happen here; each lambda pays only
                    # the fused device loop.
                    from flashdeconv_tpu.parallel import prepare_sharded_bcd

                    problem = prepare_sharded_bcd(
                        Y_sketch, X_sketch, A, coords=coords,
                        mesh=self.mesh, n_shards=self.n_shards,
                        dtype=self.solver_dtype, verbose=self.verbose,
                        xty=self.__dict__.pop("_fused_xty", None),
                        yty=self.__dict__.pop("_fused_yty", None),
                    )
                else:
                    from flashdeconv_tpu.core.solver import prepare_bcd

                    problem = prepare_bcd(
                        Y_sketch, X_sketch, A, dtype=self.solver_dtype,
                        coords=coords,
                        graph_plan=self.__dict__.pop(
                            "_graph_plan_future", None
                        ),
                        xty=self.__dict__.pop("_fused_xty", None),
                        yty=self.__dict__.pop("_fused_yty", None),
                    )
        except BaseException:
            self._clear_consume_once()  # see fit(): device-buffer orphan
            raise

        results = []
        beta_prev = None
        with timer.stage("solve"), trace("bcd_lambda_path"):
            for lam in lambdas:
                self._log(f"lambda-path solve at lambda = {lam:.4f}...")
                beta, info = problem.solve(
                    lambda_=float(lam), rho=self.rho_sparsity,
                    max_iter=self.max_iter, tol=self.tol,
                    verbose=self.verbose, beta_init=beta_prev,
                )
                beta_prev = beta
                results.append({
                    "lambda": float(lam),
                    "beta": beta,
                    "proportions": normalize_proportions(beta),
                    "info": info,
                })

        last = results[-1]
        self.lambda_used_ = last["lambda"]
        self.beta_ = last["beta"]
        self.proportions_ = last["proportions"]
        # The beta_/proportions_ setters reset the device-side caches; the
        # device argmax from a previous device-output fit must go too, or
        # get_dominant_cell_type() would return the OLD fit's vector.
        self.dominant_ = None
        self.info_ = last["info"]
        self.timings_ = timer.timings
        self._fitted = True
        return results

    def get_cell_type_proportions(self) -> np.ndarray:
        """Normalized proportions; raises if not fitted."""
        self._check_fitted()
        return self.proportions_

    def get_abundances(self) -> np.ndarray:
        """Raw (unnormalized) abundances; raises if not fitted."""
        self._check_fitted()
        return self.beta_

    def get_dominant_cell_type(self) -> np.ndarray:
        """Index of the highest-proportion cell type per spot.

        Uses the device-computed dominant vector when the fit fetched one
        (``outputs`` includes ``"dominant"``); otherwise the argmax of the
        (possibly lazily fetched) proportions.
        """
        self._check_fitted()
        if self.dominant_ is not None:
            return self.dominant_
        return np.argmax(self.proportions_, axis=1)

    def summary(self) -> Dict[str, Any]:
        """Dictionary summary of parameters and fit statistics."""
        if not self._fitted:
            return {"fitted": False}
        return {
            "fitted": True,
            "n_spots": self.n_spots_,
            "n_cell_types": self.n_cell_types_,
            "n_genes_used": len(self.gene_idx_),
            "sketch_dim": self.sketch_dim,
            "lambda_spatial": self.lambda_used_,
            "rho_sparsity": self.rho_sparsity,
            "preprocess_method": self.preprocess,
            "converged": self.info_["converged"],
            "n_iterations": self.info_["n_iterations"],
            "final_objective": self.info_["final_objective"],
        }

    def save(self, path: str) -> None:
        """Checkpoint the fitted state to an ``.npz`` file.

        Persists beta_/proportions_/gene_idx_/lambda_used_ plus the
        convergence record. The reference has no checkpointing (SURVEY.md
        §5); for atlas-scale runs beta_ is the only state worth saving —
        reload with :meth:`load` and re-solve warm-started after a failure
        or a hyperparameter tweak.
        """
        self._check_fitted()
        A = self.adjacency_.tocsr() if self.adjacency_ is not None else None
        extra = {}
        if A is not None:
            extra.update(
                adj_data=A.data, adj_indices=A.indices, adj_indptr=A.indptr
            )
        if self.cell_type_names_ is not None:
            extra["cell_type_names"] = np.asarray(self.cell_type_names_)
        np.savez_compressed(
            path,
            beta=self.beta_,
            proportions=self.proportions_,
            gene_idx=self.gene_idx_,
            lambda_used=self.lambda_used_,
            converged=self.info_["converged"],
            n_iterations=self.info_["n_iterations"],
            final_objective=self.info_["final_objective"],
            final_change=self.info_["final_change"],
            n_spots=self.n_spots_,
            n_genes=self.n_genes_,
            n_cell_types=self.n_cell_types_,
            **extra,
        )

    @classmethod
    def load(cls, path: str, **init_kwargs) -> "FlashDeconv":
        """Restore a fitted model from :meth:`save` output.

        ``init_kwargs`` are forwarded to the constructor (they must match
        the original hyperparameters if you intend to warm-start a re-fit).
        """
        data = np.load(path, allow_pickle=False)
        model = cls(**init_kwargs)
        model.beta_ = data["beta"]
        model.proportions_ = data["proportions"]
        model.gene_idx_ = data["gene_idx"]
        model.lambda_used_ = float(data["lambda_used"])
        model.n_spots_ = int(data["n_spots"])
        model.n_genes_ = int(data["n_genes"])
        model.n_cell_types_ = int(data["n_cell_types"])
        model.cell_type_names_ = (
            data["cell_type_names"] if "cell_type_names" in data else None
        )
        if "adj_data" in data:
            n = model.n_spots_
            model.adjacency_ = sparse.csr_matrix(
                (data["adj_data"], data["adj_indices"], data["adj_indptr"]),
                shape=(n, n),
            )
        else:
            model.adjacency_ = None
        model.info_ = {
            "converged": bool(data["converged"]),
            "n_iterations": int(data["n_iterations"]),
            "final_objective": float(data["final_objective"]),
            "objectives": [],
            "final_change": float(data["final_change"]),
        }
        model._fitted = True
        return model

    @property
    def beta_(self):
        """(n_spots, n_cell_types) float64 abundances.

        On the device-outputs path (see ``device_outputs``) the solve
        leaves beta on its device and only the f32 proportions are
        fetched eagerly; the first access of ``beta_`` fetches and
        converts it (then caches the host copy and releases the device
        buffer). Consumers that never touch raw abundances — e.g. a
        ``fit_transform`` pipeline — skip that (n_spots, K) transfer
        entirely.
        """
        if self._beta_host is None and self._beta_dev is not None:
            import jax

            self._beta_host = np.asarray(
                jax.device_get(self._beta_dev), dtype=np.float64
            )
            self._beta_dev = None
        return self._beta_host

    @beta_.setter
    def beta_(self, value):
        self._beta_host = value
        self._beta_dev = None

    @property
    def proportions_(self):
        """(n_spots, n_cell_types) float64 row-normalized proportions.

        With ``outputs=("dominant",)`` the fit fetches only the uint8
        dominant-type vector; proportions stay device-resident and the
        first access of this attribute fetches + converts them (honoring
        ``fetch_dtype``), then caches the host copy.
        """
        if self._props_host is None and self._props_dev is not None:
            import jax

            self._props_host = np.asarray(
                jax.device_get(self._fetch_cast(self._props_dev)),
                dtype=np.float64,
            )
            self._props_dev = None
        return self._props_host

    @proportions_.setter
    def proportions_(self, value):
        self._props_host = value
        self._props_dev = None

    def _fetch_cast(self, arr):
        """Device-side cast to the configured wire dtype (no-op when
        ``fetch_dtype`` is unset): the cast runs on the accelerator, so
        only the narrowed bytes cross the interconnect."""
        if self.fetch_dtype is None:
            return arr
        import jax.numpy as jnp

        return arr.astype(jnp.dtype(self.fetch_dtype))

    @property
    def _is_sharded(self) -> bool:
        """True when the solve dispatches to the spot-sharded mesh path."""
        return self.mesh is not None or (
            self.n_shards is not None and self.n_shards > 1
        )

    def _clear_consume_once(self):
        """Drop consume-once operand state (fused Xty/YtY — possibly a
        device buffer on the streamed path — and the graph-plan future)."""
        self.__dict__.pop("_fused_xty", None)
        self.__dict__.pop("_fused_yty", None)
        self.__dict__.pop("_graph_plan_future", None)

    def _check_fitted(self):
        if not self._fitted:
            raise RuntimeError("Model has not been fitted. Call fit() first.")

    def _log(self, msg: str):
        if self.verbose:
            print(msg)

    def __repr__(self) -> str:
        status = "fitted" if self._fitted else "not fitted"
        return (
            f"FlashDeconv(sketch_dim={self.sketch_dim}, "
            f"lambda_spatial={self.lambda_spatial}, "
            f"status={status})"
        )
