"""Host-facing BCD solver driver around the device sweep kernels.

API parity with the reference solver (reference
``flashdeconv/core/solver.py:287-452``): same signature, same ``info`` dict
contract, same rho rescaling and convergence rule — but the hot loop is a
single compiled XLA while-loop on the accelerator
(:func:`flashdeconv_tpu.ops.bcd.bcd_iterate`) instead of Numba threads.

Two entry points:

* :func:`bcd_solve` — one-shot, reference-parity signature.
* :class:`BCDProblem` (via :func:`prepare_bcd`) — splits the solve into a
  one-time *prepare* phase (host precompute: Gram/Xty matmuls, banded graph
  decomposition, padded tables, device uploads) and a *solve* phase that is
  pure device work. Re-solves over the same (Y_sketch, X_sketch, A) operands
  — lambda paths, warm restarts, benchmark repeats — skip every host pass
  and cost only the fused device while-loop. This mirrors the role of
  per-solve precomputation in the reference driver (reference
  ``flashdeconv/core/solver.py:346-347``), amortized one level higher.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import sparse

from flashdeconv_tpu.utils.graph import (
    adjacency_to_padded,
    adjacency_to_padded_capped,
)


def soft_threshold(x: float, threshold: float) -> float:
    """Scalar soft-thresholding prox (host convenience / parity helper)."""
    if x > threshold:
        return x - threshold
    if x < -threshold:
        return x + threshold
    return 0.0


def precompute_gram_matrix(X_sketch: np.ndarray) -> np.ndarray:
    """Gram matrix XtX = X_sketch @ X_sketch.T, shape (K, K).

    Raises ``ValueError`` when the Gram matrix comes out non-finite (NaN /
    Inf signatures, or f32 overflow): a poisoned XtX silently drives EVERY
    spot to the uniform fallback, which the reference returns without
    complaint (its clipped Numba update maps NaN to 0) — failing loudly
    here is deliberate; see docs/migration.md.
    """
    XtX = X_sketch @ X_sketch.T
    if not np.all(np.isfinite(XtX)):
        raise ValueError(
            "X_sketch produced a non-finite Gram matrix (NaN/Inf in the "
            "signature matrix, or overflow) — every proportion would "
            "degenerate to uniform. Check the reference signatures and "
            "preprocessing."
        )
    return XtX


def sanitize_xty_rows(Xty: np.ndarray) -> Tuple[np.ndarray, int]:
    """Zero Xty rows containing non-finite values; return (Xty, n_bad).

    A poisoned spot (NaN/Inf counts, negative values pushed through log1p)
    must not NaN its proportions row. With its Xty row zeroed: at
    ``lambda = 0`` (or an isolated spot) the row's beta is driven to 0 and
    :func:`normalize_proportions` yields uniform 1/K — exactly the
    reference's emergent outcome (reference
    ``flashdeconv/core/solver.py:75-93``: ``max(0.0, nan)`` is 0.0 under
    Numba); with spatial coupling the spot is instead IMPUTED from its
    neighbors (the ``lam * ns`` term), a deliberate divergence from the
    reference, whose pinned-zero row also contributes nothing back to its
    neighborhood — see docs/migration.md behavioral difference #6. Finite
    rows pass through untouched (no copy when nothing is bad), so every
    parity/bitwise contract on finite inputs is preserved.
    """
    bad = ~np.isfinite(Xty).all(axis=1)
    n_bad = int(bad.sum())
    if n_bad:
        Xty = Xty.copy()
        Xty[bad] = 0.0
    return Xty, n_bad


def sanitize_yty(
    yty: Optional[float], Y_sketch: Optional[np.ndarray]
) -> float:
    """Best-effort YtY of the *sanitized* problem (poisoned rows as zeros).

    ONE home for the whole YtY policy shared by every solver driver
    (``BCDProblem``, both sharded problems, ``fit_distributed``): pass
    ``yty=None`` to compute the Frobenius constant from ``Y_sketch``
    (:func:`flashdeconv_tpu.native.yty_f64`), or a precomputed value to
    sanitize only.

    The row guard (:func:`sanitize_xty_rows` / the device-side equivalent)
    makes the SOLVE treat a poisoned spot as a zero observation, but the
    objective's Frobenius constant is reduced from the raw sketch — one
    NaN count would leave ``info["final_objective"]`` (the quantity
    docs/deployment.md tells operators to monitor) NaN even though beta
    and the proportions are finite. When the reduction came out non-finite
    and the sketch rows are available, recompute it with the non-finite
    rows zeroed — the same shape and block-ordered reduction as the clean
    path, so the result is bit-identical to solving the explicitly-zeroed
    input. The degraded re-reduction avoids a second full sketch in
    memory: bad rows are found with a chunked scan (no (N, d) boolean
    temp) and zeroed IN PLACE with save/restore when the buffer is
    writable (full copy only as the read-only fallback). Exact
    pass-through for finite ``yty`` (the only case parity contracts
    cover); with no sketch to attribute against (precomputed ``yty`` +
    ``Y_sketch=None``) the caller must repair upstream (see
    ``FlashDeconv._fused_xty_feed``'s poisoned-row re-run).
    """
    from flashdeconv_tpu import native

    if yty is None:
        yty = native.yty_f64(Y_sketch)
    if np.isfinite(yty) or Y_sketch is None:
        return float(yty)
    Y_sketch = np.asarray(Y_sketch)
    n, d = Y_sketch.shape
    step = max(1, (1 << 22) // max(d, 1))  # ~4M elements per scan chunk
    bad_parts = [
        np.flatnonzero(~np.isfinite(Y_sketch[a: a + step]).all(axis=1)) + a
        for a in range(0, n, step)
    ]
    bad = (
        np.concatenate(bad_parts) if bad_parts
        else np.zeros(0, dtype=np.int64)
    )
    if bad.size == 0:
        return float(yty)  # reduction overflow, not row poison: keep honest
    if Y_sketch.flags.writeable:
        saved = Y_sketch[bad].copy()
        try:
            Y_sketch[bad] = 0.0
            return native.yty_f64(Y_sketch)
        finally:
            Y_sketch[bad] = saved
    Yz = np.array(Y_sketch, copy=True)
    Yz[bad] = 0.0
    return native.yty_f64(Yz)


def precompute_XtY(X_sketch: np.ndarray, Y_sketch: np.ndarray) -> np.ndarray:
    """H = X_sketch @ Y_sketch.T, shape (K, N) — computed once per solve."""
    return X_sketch @ Y_sketch.T


def compute_objective(
    beta: np.ndarray,
    H: np.ndarray,
    XtX: np.ndarray,
    YtY: float,
    L: sparse.spmatrix,
    lambda_: float,
    rho: float,
) -> float:
    """Objective via the algebraic expansion (host/numpy reference form).

    0.5*(YtY - 2 Tr(Y^T beta X) + Tr(beta^T beta XtX))
    + 0.5*lambda*Tr(beta^T L beta) + rho*||beta||_1

    The 0.5 on the Laplacian term matches the coordinate-update convention
    used by :func:`bcd_solve` (lambda enters the denominator undoubled).
    """
    cross = float(np.sum(beta * H.T))
    quad = float(np.sum((beta.T @ beta) * XtX))
    fidelity = 0.5 * (YtY - 2.0 * cross + quad)
    spatial = 0.5 * lambda_ * float(np.sum(beta * (L @ beta)))
    sparsity = rho * float(np.sum(np.abs(beta)))
    return fidelity + spatial + sparsity


def _device_platform(arr) -> str:
    """Platform of the device holding ``arr`` ("gpu", "cpu", ...)."""
    return next(iter(arr.devices())).platform


def use_sweep_kernel(platform: str, dtype, n_types: int,
                     overflow: bool = False) -> bool:
    """Whether a solve runs the GPU Pallas sweep kernel
    (:mod:`flashdeconv_tpu.ops.sweep_kernel`): float32 on a GPU, K within
    the kernel's measured cap, and no overflow edge list (the kernel reads
    every neighbour from its tables; a degree-capped gather table's spilled
    edges need the XLA segment sum)."""
    from flashdeconv_tpu.ops.sweep_kernel import KERNEL_MAX_K

    return (
        platform == "gpu"
        and np.dtype(dtype) == np.float32
        and n_types <= KERNEL_MAX_K
        and not overflow
    )


class GraphDecomposition:
    """Precomputed banded-vs-gather analysis of one adjacency matrix.

    Everything :class:`BCDProblem` derives from ``(A, coords, n_spots)``
    alone — the banded split, the optional scrambled-grid re-sort
    permutation, and the solve-order adjacency. Computing it is a pure
    host pass, so a pipeline can run it on a background thread as soon as
    the spatial graph exists (it depends on neither the sketch nor any
    device state) and hand it to :func:`prepare_bcd` via ``graph_plan=``.
    """

    __slots__ = ("use_banded", "perm", "A_solve", "offsets", "masks",
                 "A_rest")

    def __init__(self, A: sparse.spmatrix, n_spots: int,
                 coords: Optional[np.ndarray] = None):
        from flashdeconv_tpu.utils.graph import banded_split

        self.use_banded = False
        self.perm = None
        self.A_solve = A
        self.offsets = self.masks = self.A_rest = None
        if n_spots < 8192:
            return
        # 32 offsets: grid kNN graphs have ~18 distinct diagonals; capping
        # at 16 strands a few corner edges in the gather remainder.
        offsets_np, masks_np, A_rest = banded_split(
            A, max_offsets=32, min_coverage=0.9
        )
        if (
            offsets_np.size == 0
            and coords is not None
            and np.asarray(coords).ndim == 2
            and np.asarray(coords).shape[1] >= 2
        ):
            cand = np.lexsort(
                (np.asarray(coords)[:, 0], np.asarray(coords)[:, 1])
            )
            A_cand = A.tocsr()[cand][:, cand]
            off_c, masks_c, rest_c = banded_split(
                A_cand, max_offsets=32, min_coverage=0.9
            )
            if off_c.size:
                self.perm = cand
                self.A_solve = A_cand
                offsets_np, masks_np, A_rest = off_c, masks_c, rest_c
        self.offsets, self.masks, self.A_rest = offsets_np, masks_np, A_rest
        self.use_banded = offsets_np.size > 0


def _degenerate_result(n_spots: int, n_types: int) -> Tuple[np.ndarray, dict]:
    """Empty-input / zero-iteration fast path (reference ``solver.py:334-343``)."""
    beta = np.full((n_spots, n_types), 1.0 / max(n_types, 1), dtype=np.float64)
    if n_spots == 0 or n_types == 0:
        beta = np.empty((n_spots, n_types), dtype=np.float64)
    return beta, {
        "converged": n_spots == 0 or n_types == 0,
        "n_iterations": 0,
        "final_objective": 0.0,
        "objectives": [],
        "final_change": 0.0,
    }


class BCDProblem:
    """A prepared BCD solve: device-resident operands + graph decomposition.

    Construction performs every host pass the solve needs — the (N, K)
    ``Xty = Y_sketch @ X_sketch.T`` matmul, the f64 Gram/YtY reductions, the
    banded-vs-gather graph decomposition (with optional coordinate re-sort),
    degree-capped padded neighbor tables — and uploads the results to the
    accelerator once. :meth:`solve` then runs only the device while-loop; hyperparameters (lambda, rho, tol) are traced
    scalars, so re-solves reuse one compiled executable per
    (shape, max_iter) pair.

    Parameters
    ----------
    Y_sketch : (n_spots, sketch_dim) sketched spatial data
    X_sketch : (n_cell_types, sketch_dim) sketched signatures
    A : (n_spots, n_spots) sparse adjacency
    dtype : device compute dtype (float32 on GPU; float64 needs x64)
    coords : optional (n_spots, >=2) coordinates — performance hint only:
        when the graph is not banded in input order, a row-major (y, x)
        re-sort is attempted so scrambled grid/hex lattices still hit the
        banded fast path. Results always return in the original spot order.
    max_degree : optional int — cap on the padded neighbor table's width
        (gather path). Default (None) caps at 1.5x the 99.9th-percentile
        degree, which never binds on kNN graphs but keeps one dense cluster
        in a radius/hub graph from blowing the table up to O(N * max_deg);
        excess edges spill to an exact overflow edge list
        (:func:`flashdeconv_tpu.ops.bcd.overflow_sum`).
    """

    def __init__(
        self,
        Y_sketch: np.ndarray,
        X_sketch: np.ndarray,
        A: sparse.spmatrix,
        dtype=np.float32,
        coords: Optional[np.ndarray] = None,
        max_degree: Optional[int] = None,
        graph_plan: Optional[GraphDecomposition] = None,
        xty: Optional[np.ndarray] = None,
        yty: Optional[float] = None,
    ):
        import jax
        import jax.numpy as jnp

        if Y_sketch is None and (xty is None or yty is None):
            raise ValueError(
                "Y_sketch=None requires both xty and yty precomputed "
                "(e.g. from native.fused_log1pcpm_xty)."
            )
        if xty is not None and np.shape(xty) != (
            A.shape[0], int(X_sketch.shape[0])
        ):
            raise ValueError(
                f"xty shape {np.shape(xty)} does not match the adjacency / "
                f"signature dimensions ({A.shape[0]}, {X_sketch.shape[0]})"
            )
        self.n_spots = int(
            Y_sketch.shape[0] if Y_sketch is not None else xty.shape[0]
        )
        self.n_types = int(X_sketch.shape[0])
        self.dtype = np.dtype(dtype)
        self._degenerate = self.n_spots == 0 or self.n_types == 0
        if self._degenerate:
            return

        n_spots, n_types = self.n_spots, self.n_types

        XtX = precompute_gram_matrix(np.asarray(X_sketch, dtype=np.float64))

        # Compute Xty and dispatch its upload FIRST: jnp.asarray returns as
        # soon as the transfer is enqueued, so the graph decomposition and
        # YtY reduction below run on the host while the bytes stream. Any banded re-sort
        # permutation is applied to the device copy afterwards (an exact
        # row gather, sub-ms on device).
        if xty is not None:
            if isinstance(xty, jax.Array):
                # Already device-resident (the pipeline's streamed chunked
                # upload, core/deconv._fused_xty_feed): cast on device.
                Xty_raw_d = jnp.asarray(xty, dtype=self.dtype)
            else:
                Xty_raw_d = jnp.asarray(np.asarray(xty, dtype=self.dtype))
        else:
            Xty_raw_d = jnp.asarray(
                np.asarray(Y_sketch @ X_sketch.T, dtype=self.dtype)
            )  # (n_spots, K), input order
        # Non-finite guard, applied ON DEVICE so the streamed prepare never
        # syncs (see sanitize_xty_rows for the semantics — poisoned spots
        # are spatially imputed under lambda > 0, uniform otherwise).
        # jnp.where is an exact pass-through for finite rows, so the f64
        # bit-determinism contract is untouched; the
        # count stays device-resident and is only fetched by the lazy
        # n_nonfinite_spots property.
        finite_row = jnp.all(jnp.isfinite(Xty_raw_d), axis=1, keepdims=True)
        self._xty_bad_d = jnp.sum(~finite_row, dtype=jnp.int32)
        Xty_raw_d = jnp.where(
            finite_row, Xty_raw_d, jnp.zeros((), self.dtype)
        )
        # rho is user-facing dimensionless: rescaled by the Gram diagonal so
        # the soft threshold is commensurate with the residual magnitude.
        self.mean_diag = float(np.mean(np.diag(XtX)))

        # Banded neighbor decomposition: on grid-structured graphs (or any
        # locality-ordered planar graph) the neighbor sum becomes a handful
        # of contiguous shifted adds instead of a random row gather. Used
        # when >=90% of edges fall on <=32 diagonal offsets and the problem
        # is big enough for gather cost to matter. When the input order is
        # scrambled but coordinates are available, a row-major (y, x)
        # re-sort is attempted — grids and hex lattices become banded under
        # it; beta is returned in the original order. Accepts a precomputed
        # plan (graph_plan=) — either a GraphDecomposition or a Future of
        # one, joined only now, AFTER the Xty upload is already streaming —
        # so pipelines can run this analysis on a background thread while
        # earlier stages execute.
        if graph_plan is not None and hasattr(graph_plan, "result"):
            graph_plan = graph_plan.result()
        if graph_plan is None:
            graph_plan = GraphDecomposition(A, n_spots, coords=coords)
        use_banded = graph_plan.use_banded
        perm = graph_plan.perm
        A_solve = graph_plan.A_solve
        self.use_banded = use_banded
        self.perm = perm

        ov_src = ov_dst = None
        if use_banded:
            # No gather table at all on the banded path: degrees suffice.
            # Binary degree (nnz per row), NOT edge-weight sums — the sweep
            # kernels treat every edge as weight 1, matching the reference's
            # CSR-index iteration.
            n_nbrs = np.diff(A_solve.tocsr().indptr).astype(np.int32)
            self.halo = int(np.max(np.abs(graph_plan.offsets)))
            self.offsets = tuple(int(o) for o in graph_plan.offsets)
            if graph_plan.A_rest.nnz:
                rest_nbr_np, _ = adjacency_to_padded(graph_plan.A_rest)
            else:
                rest_nbr_np = np.zeros((n_spots, 0), dtype=np.int32)
        else:
            nbr_idx, n_nbrs, ov_src, ov_dst = adjacency_to_padded_capped(
                A_solve, max_degree=max_degree
            )
            if ov_src.size == 0:
                ov_src = ov_dst = None

        # Remaining device operands (uploaded once). The already-streaming
        # Xty copy is permuted on device in its (N, K) form — never on the
        # (N, d) sketch.
        Xty_d = Xty_raw_d
        if perm is not None:
            Xty_d = jnp.take(Xty_d, jnp.asarray(perm, dtype=jnp.int32),
                             axis=0)
        self.Xty_d = Xty_d  # (n_spots, K)
        self.XtX_d = jnp.asarray(XtX, dtype=self.dtype)
        self.nnb_d = jnp.asarray(n_nbrs, dtype=self.dtype)
        if use_banded:
            # The masks are 0/1: kept as uint8 on device (4x fewer bytes
            # per sweep); every consumer widens them where it multiplies.
            self.masks_d = jnp.asarray(graph_plan.masks.astype(np.uint8))
            self.rest_d = jnp.asarray(rest_nbr_np)
        else:
            self.nbr_d = jnp.asarray(nbr_idx)
            self.ov_src_d = jnp.asarray(ov_src) if ov_src is not None else None
            self.ov_dst_d = jnp.asarray(ov_dst) if ov_dst is not None else None
        if perm is not None:
            inv = np.empty(n_spots, dtype=np.int32)
            inv[perm] = np.arange(n_spots, dtype=np.int32)
            self._inv_perm_d = jnp.asarray(inv)

        # Sweep implementation: the GPU Pallas kernel where it applies
        # (ops/sweep_kernel), the XLA sweeps everywhere else.
        self.sweep_kernel = (
            "pallas_triton"
            if use_sweep_kernel(
                _device_platform(Xty_d), self.dtype, n_types,
                overflow=ov_src is not None,
            )
            else "xla"
        )

        # YtY: f64-accumulated without materializing a float64 copy of
        # Y_sketch (the copy costs ~8 GB at 1M x 512). The threaded native
        # reduction takes over at atlas scale (different last-ULP
        # association than einsum — it only feeds the objective constant);
        # small problems keep einsum's exact sequential accumulation.
        self.YtY = sanitize_yty(yty, Y_sketch)
        self.YtY_d = jnp.asarray(self.YtY, dtype=self.dtype)

    @property
    def n_nonfinite_spots(self) -> int:
        """Spots whose Xty row contained NaN/Inf and was zeroed at prepare
        time (spatially imputed under lambda > 0, uniform otherwise — see
        :func:`sanitize_xty_rows`). Reading this fetches a device scalar,
        i.e. it synchronizes with the device."""
        bad = getattr(self, "_xty_bad_d", None)
        if bad is None:
            return 0
        import jax

        return int(jax.device_get(bad))

    # -- internal device closures -----------------------------------------
    @property
    def _tier(self) -> str:
        return "banded" if self.use_banded else "gather"

    def _operands(self) -> dict:
        ops = {"Xty": self.Xty_d, "XtX": self.XtX_d, "YtY": self.YtY_d,
               "nnb": self.nnb_d}
        if self.use_banded:
            ops["masks"] = self.masks_d
            ops["rest"] = self.rest_d
        else:
            ops["nbr"] = self.nbr_d
            if self.ov_src_d is not None:
                ops["ov_src"] = self.ov_src_d
                ops["ov_dst"] = self.ov_dst_d
        return ops

    def _static(self) -> dict:
        return dict(
            tier=self._tier,
            offsets=self.offsets if self.use_banded else None,
            halo=self.halo if self.use_banded else 0,
        )

    def _beta0(self, beta_init: Optional[np.ndarray]):
        import jax.numpy as jnp

        if beta_init is None:
            return jnp.full(
                (self.n_spots, self.n_types), 1.0 / self.n_types,
                dtype=self.dtype,
            )
        if beta_init.shape != (self.n_spots, self.n_types):
            raise ValueError(
                f"beta_init shape {beta_init.shape} does not match "
                f"({self.n_spots}, {self.n_types})"
            )
        b0 = np.maximum(np.asarray(beta_init, dtype=self.dtype), 0.0)
        if self.perm is not None:
            b0 = b0[self.perm]
        return jnp.asarray(b0, dtype=self.dtype)

    def solve(
        self,
        lambda_: float = 0.1,
        rho: float = 0.01,
        max_iter: int = 100,
        tol: float = 1e-4,
        verbose: bool = False,
        beta_init: Optional[np.ndarray] = None,
        return_device: bool = False,
    ) -> Tuple[np.ndarray, dict]:
        """Run the device solve on the prepared operands.

        Parameters match :func:`bcd_solve`. ``return_device=True`` returns
        beta as a device array in the solve dtype (already un-permuted)
        instead of fetching it to host float64.

        Returns (beta, info) with the standard info contract plus
        ``info["sweep_kernel"]``: ``"pallas_triton"`` when the GPU sweep
        kernel ran, ``"xla"`` otherwise.
        """
        import jax
        import jax.numpy as jnp

        if self._degenerate or max_iter == 0:
            return _degenerate_result(self.n_spots, self.n_types)

        from flashdeconv_tpu.ops import bcd

        lam_d = jnp.asarray(lambda_, dtype=self.dtype)
        rho_d = jnp.asarray(rho * self.mean_diag, dtype=self.dtype)
        tol_d = jnp.asarray(tol, dtype=self.dtype)
        operands = self._operands()
        static = self._static()
        kernel = self.sweep_kernel == "pallas_triton"
        inv_perm = self._inv_perm_d if self.perm is not None else None

        objectives: list = []
        if verbose:
            # Chunked device loop on the reference cadence (see
            # flashdeconv_tpu.ops.bcd.chunked_verbose_solve). The chunk
            # length is a *traced* cap, so neither chunking nor the tail
            # ever triggers a recompile.
            beta_d, n_iter, rel_change, converged, objectives = (
                bcd.chunked_verbose_solve(
                    lambda b, cap: bcd.iterate(
                        b, operands, lam_d, rho_d, tol_d, cap,
                        max_iter=max_iter, kernel=kernel, **static,
                    ),
                    lambda b: bcd.objective(
                        b, operands, lam_d, rho_d, **static
                    ),
                    self._beta0(beta_init), max_iter, tol,
                )
            )
            # every loop exit just evaluated the objective at the final beta
            final_obj = objectives[-1]
            if inv_perm is not None:
                beta_d = jnp.take(beta_d, inv_perm, axis=0)
        else:
            cap = jnp.asarray(max_iter, dtype=jnp.int32)
            if self.dtype == np.float32:
                # The whole solve is ONE compiled program (loop + objective
                # + un-permute).
                beta0 = None if beta_init is None else self._beta0(beta_init)
                beta_d, n_iter_d, rel_d, obj_d = bcd.solve_program(
                    beta0, operands, inv_perm, lam_d, rho_d, tol_d, cap,
                    max_iter=max_iter, kernel=kernel, n_spots=self.n_spots,
                    **static,
                )
            else:
                # float64 keeps the separately compiled loop and objective
                # (the same executables as the verbose path): its CPU
                # trajectories are pinned to the reference implementation,
                # and a re-composed program is not worth any fusion-order
                # risk there.
                beta_d, n_iter_d, rel_d = bcd.iterate(
                    self._beta0(beta_init), operands, lam_d, rho_d, tol_d,
                    cap, max_iter=max_iter, kernel=kernel, **static,
                )
                obj_d = bcd.objective(beta_d, operands, lam_d, rho_d,
                                      **static)
                if inv_perm is not None:
                    beta_d = jnp.take(beta_d, inv_perm, axis=0)
            # One bundled device_get fetches the scalars and, when the
            # caller wants beta on host, beta itself.
            fetch = (n_iter_d, rel_d, obj_d)
            if not return_device:
                fetch = fetch + (beta_d,)
            fetched = jax.device_get(fetch)
            n_iter = int(fetched[0])
            rel_change = float(fetched[1])
            final_obj = float(fetched[2])
            converged = rel_change < tol
            if not return_device:
                beta_d = fetched[3]

        info = {
            "converged": bool(converged),
            "n_iterations": int(n_iter),
            "final_objective": final_obj,
            "objectives": objectives,
            "final_change": float(rel_change),
            "sweep_kernel": self.sweep_kernel,
        }
        if return_device:
            return beta_d, info
        return np.asarray(beta_d, dtype=np.float64), info


def prepare_bcd(
    Y_sketch: np.ndarray,
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    dtype=np.float32,
    coords: Optional[np.ndarray] = None,
    max_degree: Optional[int] = None,
    graph_plan: Optional[GraphDecomposition] = None,
    xty: Optional[np.ndarray] = None,
    yty: Optional[float] = None,
) -> BCDProblem:
    """Build a :class:`BCDProblem`: host precompute + device upload, once.

    ``xty``/``yty`` optionally supply the (n_spots, K) ``Y_sketch @
    X_sketch.T`` product and the Frobenius constant precomputed elsewhere
    (e.g. the pipeline's fused sketch kernel) — with both given,
    ``Y_sketch`` may be None and is never touched.
    """
    return BCDProblem(
        Y_sketch, X_sketch, A, dtype=dtype, coords=coords,
        max_degree=max_degree, graph_plan=graph_plan, xty=xty, yty=yty,
    )


def bcd_solve(
    Y_sketch: np.ndarray,
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    lambda_: float = 0.1,
    rho: float = 0.01,
    max_iter: int = 100,
    tol: float = 1e-4,
    verbose: bool = False,
    dtype=np.float32,
    beta_init: Optional[np.ndarray] = None,
    coords: Optional[np.ndarray] = None,
    max_degree: Optional[int] = None,
    graph_plan: Optional[GraphDecomposition] = None,
    xty: Optional[np.ndarray] = None,
    yty: Optional[float] = None,
    return_device: bool = False,
) -> Tuple[np.ndarray, dict]:
    """Solve min 0.5||Y - beta X||^2 + 0.5*lambda Tr(beta^T L beta) + rho||beta||_1, beta >= 0.

    One-shot driver: prepares the problem (host precompute + device upload)
    and solves. For repeated solves over the same operands — lambda paths,
    warm restarts, benchmarking — use :func:`prepare_bcd` once and call
    :meth:`BCDProblem.solve` per solve; it skips all host work.

    Parameters
    ----------
    Y_sketch : (n_spots, sketch_dim) sketched spatial data
    X_sketch : (n_cell_types, sketch_dim) sketched signatures
    A : (n_spots, n_spots) sparse adjacency
    lambda_ : spatial regularization strength
    rho : dimensionless L1 strength; internally scaled by mean(diag(XtX))
    max_iter, tol : sweep budget and relative-change stopping rule
    verbose : print objective every 10 sweeps (chunked device loop on the
        reference cadence; the non-verbose path fuses the entire solve into
        one device while-loop)
    dtype : device compute dtype (float32 on GPU; float64 needs x64)
    beta_init : optional (n_spots, n_cell_types) warm-start abundances
        (e.g. a previous solve's ``beta_``); default cold-start is uniform
        1/K. Warm starting typically halves sweep counts on re-solves with
        perturbed data or hyperparameters.
    coords : optional (n_spots, >=2) spatial coordinates. Only used as a
        performance hint: when the graph is not banded in its input order,
        a row-major (y, x) re-sort is attempted so scrambled grid / hex
        lattices still hit the banded fast path; results are returned in
        the original spot order regardless.
    max_degree : optional cap on the padded neighbor table width; see
        :class:`BCDProblem`.
    graph_plan : optional precomputed :class:`GraphDecomposition` for A —
        lets a pipeline run the banded analysis on a background thread
        while earlier stages execute.
    xty, yty : optional precomputed ``Y_sketch @ X_sketch.T`` / Frobenius
        constant (see :func:`prepare_bcd`); with both given, ``Y_sketch``
        may be None.

    Returns
    -------
    beta : (n_spots, n_cell_types) float64 abundances
    info : {"converged", "n_iterations", "final_objective", "objectives",
            "final_change"}
    """
    n_spots = (Y_sketch if Y_sketch is not None else xty).shape[0]
    n_types = X_sketch.shape[0]
    if n_spots == 0 or n_types == 0 or max_iter == 0:
        return _degenerate_result(n_spots, n_types)

    problem = BCDProblem(
        Y_sketch, X_sketch, A, dtype=dtype, coords=coords,
        max_degree=max_degree, graph_plan=graph_plan, xty=xty, yty=yty,
    )
    return problem.solve(
        lambda_=lambda_, rho=rho, max_iter=max_iter, tol=tol,
        verbose=verbose, beta_init=beta_init, return_device=return_device,
    )


def normalize_proportions(beta: np.ndarray) -> np.ndarray:
    """Row-normalize abundances to proportions; all-zero rows become uniform."""
    beta = np.asarray(beta, dtype=np.float64)
    row_sums = beta.sum(axis=1, keepdims=True)
    zero_rows = (row_sums == 0).ravel()
    proportions = beta / np.maximum(row_sums, 1e-10)
    if np.any(zero_rows):
        proportions[zero_rows] = 1.0 / beta.shape[1]
    return proportions


_NORMALIZE_DEVICE_JIT = None


def normalize_proportions_device(beta):
    """Device-side :func:`normalize_proportions` (same zero-row rule).

    Runs in the solve dtype on the array's device so a fit can fetch the
    proportions directly — the host f64 conversion and normalize pass
    disappear from the pipeline, and downstream device consumers never
    leave device memory. Matches the host path
    to solve-dtype (f32) resolution.
    """
    global _NORMALIZE_DEVICE_JIT
    if _NORMALIZE_DEVICE_JIT is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def _f(b):
            s = jnp.sum(b, axis=1, keepdims=True)
            p = b / jnp.maximum(s, jnp.asarray(1e-10, b.dtype))
            return jnp.where(s == 0.0, jnp.asarray(1.0 / b.shape[1], b.dtype), p)

        _NORMALIZE_DEVICE_JIT = _f
    import jax.numpy as jnp

    return _NORMALIZE_DEVICE_JIT(jnp.asarray(beta))
