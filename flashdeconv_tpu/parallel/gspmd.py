"""GSPMD spot-sharded BCD solve for fully banded (grid) graphs.

The shard_map solver (:mod:`flashdeconv_tpu.parallel.solver`) plans halo
exchange explicitly — necessary for irregular graphs. On grid platforms the
banded decomposition makes a lighter design possible: write the sweep as
**global** array ops over spot-sharded operands and let XLA's SPMD
partitioner insert the communication. The banded neighbor sum is a set of
*static* shifted slices of beta; under a 1-D ``"spots"`` mesh each shift
partitions into a neighbor-shard halo transfer of exactly ``offset`` rows
(a collective-permute), and the convergence ``max`` becomes an
all-reduce — the compiler derives the same communication pattern the manual
plan computes, with no index bookkeeping.

The coordinate pass is plain XLA, auto-partitioned: it is row-parallel.

Numerics are identical to the single-device banded path: same static
shifts, same coordinate updates, same convergence rule.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
from scipy import sparse

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flashdeconv_tpu.parallel._runner import (
    put_addressable,
    run_prepared_solve,
    validate_beta_init,
)
from flashdeconv_tpu.ops.bcd import (
    converge_loop,
    coordinate_descent,
    neighbor_sum_banded,
    sweep_stats,
)

_AXIS = "spots"


@partial(
    jax.jit,
    static_argnames=("offsets", "halo", "max_iter", "mesh"),
)
def _gspmd_iterate(
    beta0, Xty, XtX, masks, nnb, lam, rho, tol, iter_cap,
    offsets: Tuple[int, ...], halo: int, max_iter: int, mesh: Mesh,
):
    # (N, 0) rest table: the banded decomposition is required to be complete
    # here, so neighbor_sum_banded's gather branch is statically skipped.
    empty_rest = jnp.zeros((beta0.shape[0], 0), dtype=jnp.int32)

    def sweep(beta):
        ns = neighbor_sum_banded(beta, offsets, masks, empty_rest, halo)
        beta_new = coordinate_descent(beta, Xty, XtX, ns, nnb, lam, rho)
        return (beta_new, *sweep_stats(beta_new, beta))

    return converge_loop(sweep, beta0, tol, max_iter, iter_cap=iter_cap)


class GspmdBandedProblem:
    """Prepared GSPMD banded problem: banded analysis, host precompute
    (XtX / YtY / Xty), and the device scatter of every beta-independent
    operand run ONCE in the constructor; each :meth:`solve` call reuses the
    resident sharded arrays and pays only the per-solve scalars (lambda,
    rho, tol) plus the device solve loop. The mesh-path analog of
    :class:`flashdeconv_tpu.core.solver.BCDProblem`.

    ``xty`` / ``yty`` optionally supply ``Y_sketch @ X_sketch.T`` and the
    Frobenius constant precomputed elsewhere (e.g. the pipeline's fused
    sketch kernel, ``native.fused_log1pcpm_xty``) — with both given,
    ``Y_sketch`` may be None and is never touched: the solver consumes the
    sketch only through these two reductions.

    Raises ``ValueError`` if the graph is not 100% banded within 32 offsets
    — callers should fall back to the halo plan in that case. ``_split``
    lets a dispatching caller pass its already-computed
    ``banded_split(A, 32)`` result to avoid a second O(nnz) pass.
    """

    def __init__(
        self,
        Y_sketch: Optional[np.ndarray],
        X_sketch: np.ndarray,
        A: sparse.spmatrix,
        mesh: Optional[Mesh] = None,
        dtype=np.float32,
        verbose: bool = False,
        _split=None,
        xty: Optional[np.ndarray] = None,
        yty: Optional[float] = None,
    ):
        from flashdeconv_tpu.utils.graph import banded_split

        if Y_sketch is None and (xty is None or yty is None):
            raise ValueError(
                "Y_sketch=None requires both xty and yty precomputed."
            )
        n_types = int(X_sketch.shape[0])
        if xty is not None and np.shape(xty) != (A.shape[0], n_types):
            raise ValueError(
                f"xty shape {np.shape(xty)} does not match the adjacency / "
                f"signature dimensions ({A.shape[0]}, {n_types})"
            )
        n_spots = int(
            Y_sketch.shape[0] if Y_sketch is not None else xty.shape[0]
        )
        self.n_spots, self.n_types = n_spots, n_types
        self.dtype = np.dtype(dtype)

        offsets_np, masks_np, A_rest = (
            _split if _split is not None else banded_split(A, max_offsets=32)
        )
        if A.nnz > 0 and (offsets_np.size == 0 or A_rest.nnz > 0):
            raise ValueError(
                "Graph is not fully banded; use sharded_bcd_solve instead "
                f"(rest edges: {A_rest.nnz})."
            )

        if mesh is None:
            mesh = Mesh(np.asarray(jax.devices()), (_AXIS,))
        self.mesh = mesh
        self.n_shards = mesh.devices.size

        self.halo = int(np.max(np.abs(offsets_np))) if offsets_np.size else 0

        # Shards are padded to a multiple of 8 spots each.
        block = 8
        chunk = self.n_shards * block
        n_pad = -(-n_spots // chunk) * chunk
        pad = n_pad - n_spots
        self.n_pad = n_pad

        from flashdeconv_tpu.core.solver import (
            precompute_gram_matrix,
            sanitize_xty_rows,
            sanitize_yty,
        )

        XtX = precompute_gram_matrix(np.asarray(X_sketch, np.float64))
        YtY = sanitize_yty(yty, Y_sketch)
        self.rho_scale = float(np.mean(np.diag(XtX)))

        if xty is not None:
            Xty = np.asarray(xty, dtype=dtype)
        else:
            Xty = np.asarray(Y_sketch @ X_sketch.T, dtype=dtype)
        # Host-side non-finite guard (before the pad); semantics in
        # core.solver.sanitize_xty_rows.
        Xty, self.n_nonfinite_spots = sanitize_xty_rows(Xty)
        # Binary degree (nnz per row), NOT edge-weight sums: the sweep
        # kernels treat every edge as weight 1 (reference CSR semantics).
        nnb = np.diff(A.tocsr().indptr).astype(dtype)
        if pad:
            Xty = np.concatenate(
                [Xty, np.zeros((pad, n_types), dtype=dtype)]
            )
            nnb = np.concatenate([nnb, np.zeros(pad, dtype=dtype)])
            masks_np = np.concatenate(
                [masks_np, np.zeros((masks_np.shape[0], pad), np.float32)],
                axis=1,
            )
        self.offsets = tuple(int(o) for o in offsets_np)

        self._shard = NamedSharding(mesh, P(_AXIS))
        shard_cols = NamedSharding(mesh, P(None, _AXIS))
        self._repl = NamedSharding(mesh, P())

        put = self._put
        self.Xty_d = put(Xty, self._shard)
        self.nnb_d = put(nnb, self._shard)
        # 0/1 masks stay uint8 on device (4x fewer bytes); the sweep and
        # the objective widen them where they multiply.
        self.masks_d = put(masks_np.astype(np.uint8), shard_cols)
        self.XtX_d = put(XtX.astype(dtype), self._repl)
        self.YtY_d = put(np.asarray(YtY, dtype=dtype), self._repl)
        self.rest_d = put(np.zeros((n_pad, 0), dtype=np.int32), self._shard)
        # Default uniform init, built lazily on the first no-init solve and
        # then kept resident (the solve loop does not donate its inputs) —
        # warm-start-only workloads (fit_lambda_path after lambda 0) never
        # pay the (n_pad, K) device residency.
        self._beta0_uniform_d = None

        if verbose:
            print(
                f"GSPMD banded solve: {self.n_shards} shards x "
                f"{n_pad // self.n_shards} spots, {len(self.offsets)} bands, "
                f"halo {self.halo}, XLA sweep"
            )

    def _put(self, arr, sharding):
        return put_addressable(arr, sharding)

    def _beta0_default(self):
        if self._beta0_uniform_d is None:
            beta0_np = np.zeros((self.n_pad, self.n_types), dtype=self.dtype)
            beta0_np[: self.n_spots] = 1.0 / self.n_types
            self._beta0_uniform_d = self._put(beta0_np, self._shard)
        return self._beta0_uniform_d

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
        """Run the device solve on the resident operands; see module
        docstring for semantics and objective-precision notes.

        ``return_device=True`` returns beta as the sharded device array in
        the solve dtype (only the convergence/objective scalars cross the
        interconnect) instead of a gathered host float64 copy.
        """
        n_spots, n_types = self.n_spots, self.n_types
        dtype = self.dtype
        if max_iter == 0:
            beta = np.full((n_spots, n_types), 1.0 / max(n_types, 1))
            return beta, {
                "converged": False,
                "n_iterations": 0,
                "final_objective": 0.0,
                "objectives": [],
                "final_change": 0.0,
                "n_shards": self.n_shards,
                "n_bands": len(self.offsets),
                "halo_width": self.halo,
            }

        validate_beta_init(beta_init, n_spots, n_types)
        if beta_init is not None:
            beta0_np = np.zeros((self.n_pad, n_types), dtype=dtype)
            beta0_np[:n_spots] = np.maximum(beta_init, 0.0)
            beta0_d = self._put(beta0_np, self._shard)
        else:
            beta0_d = self._beta0_default()

        rho_eff = float(rho) * self.rho_scale
        lam_d = self._put(np.asarray(lambda_, dtype=dtype), self._repl)
        rho_d = self._put(np.asarray(rho_eff, dtype=dtype), self._repl)
        tol_d = self._put(np.asarray(tol, dtype=dtype), self._repl)

        def run_chunk(beta_d, cap):
            return _gspmd_iterate(
                beta_d, self.Xty_d, self.XtX_d, self.masks_d, self.nnb_d,
                lam_d, rho_d, tol_d, cap, self.offsets, self.halo,
                max_iter, self.mesh,
            )

        def eval_objective(beta_d):
            # Global banded objective over spot-sharded operands; GSPMD
            # partitions the shifted slices and all-reduces the scalars.
            from flashdeconv_tpu.ops.bcd import objective_terms_banded

            return objective_terms_banded(
                beta_d, self.Xty_d, self.XtX_d, self.YtY_d, self.offsets,
                self.masks_d, self.rest_d, self.nnb_d, lam_d, rho_d,
                self.halo,
            )

        beta_pad, n_iter, rel_change, final_obj, converged, objectives = (
            run_prepared_solve(
                run_chunk, eval_objective, beta0_d, max_iter, tol, verbose,
                return_device=return_device,
            )
        )
        beta = beta_pad[:n_spots]

        info = {
            "converged": converged,
            "n_iterations": n_iter,
            "final_objective": final_obj,
            "objectives": objectives,
            "final_change": rel_change,
            "n_shards": self.n_shards,
            "n_bands": len(self.offsets),
            "halo_width": self.halo,
            "sweep_kernel": "xla",
        }
        return beta, info


def gspmd_banded_solve(
    Y_sketch: np.ndarray,
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    lambda_: float = 0.1,
    rho: float = 0.01,
    max_iter: int = 100,
    tol: float = 1e-4,
    mesh: Optional[Mesh] = None,
    verbose: bool = False,
    dtype=np.float32,
    beta_init: Optional[np.ndarray] = None,
    _split=None,
) -> Tuple[np.ndarray, dict]:
    """One-shot spot-sharded solve for a fully banded adjacency: construct
    a :class:`GspmdBandedProblem` and solve it (see module docstring).

    Raises ``ValueError`` if the graph is not 100% banded within 32 offsets —
    callers should fall back to :func:`~flashdeconv_tpu.parallel.solver.
    sharded_bcd_solve` (explicit halo plan) in that case.

    Objective precision: as in :func:`~flashdeconv_tpu.parallel.solver.
    sharded_bcd_solve`, the objective is evaluated on device in ``dtype``
    (YtY included) — f32 solves report with f32 quantization; use
    ``dtype=np.float64`` for exact-parity reporting.
    """
    n_spots = Y_sketch.shape[0]
    n_types = X_sketch.shape[0]

    if n_spots == 0 or n_types == 0 or max_iter == 0:
        beta = np.full((n_spots, n_types), 1.0 / max(n_types, 1))
        if n_spots == 0 or n_types == 0:
            beta = np.empty((n_spots, n_types))
        return beta, {
            "converged": n_spots == 0 or n_types == 0,
            "n_iterations": 0,
            "final_objective": 0.0,
            "objectives": [],
            "final_change": 0.0,
            "n_shards": 1 if mesh is None else mesh.devices.size,
            "n_bands": 0,
            "halo_width": 0,
        }

    problem = GspmdBandedProblem(
        Y_sketch, X_sketch, A, mesh=mesh, dtype=dtype, verbose=verbose,
        _split=_split,
    )
    return problem.solve(
        lambda_=lambda_, rho=rho, max_iter=max_iter, tol=tol,
        verbose=verbose, beta_init=beta_init,
    )
