"""Distributed BCD solve: spot-sharded ``shard_map`` over a device mesh.

Device-mesh replacement for the reference's shared-memory thread fan-out
(reference ``flashdeconv/core/solver.py:104-184``): the ``prange`` over spots
becomes the mesh shard axis, the Jacobi neighbor reads become a per-sweep
boundary-row ``all_gather`` (halo exchange planned host-side by
:mod:`flashdeconv_tpu.parallel.partition`), and the one global reduction per
sweep (reference ``core/solver.py:395-397``) becomes two ``lax.pmax`` scalars.

The per-shard sweep body reuses the single-device kernels
(:mod:`flashdeconv_tpu.ops.bcd`) verbatim — identical Gauss-Seidel-within /
Jacobi-across iterate path, so sharded and single-device solves agree to
floating-point rounding at any shard count.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
from scipy import sparse

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flashdeconv_tpu.ops.bcd import (
    converge_loop,
    coordinate_descent,
    neighbor_sum,
    sweep_stats,
)
from flashdeconv_tpu.parallel._runner import (
    device_unpermute,
    put_addressable,
    run_prepared_solve,
    validate_beta_init,
)
from flashdeconv_tpu.parallel.partition import ShardPlan, plan_shards

_AXIS = "spots"

# Minimum problem size for the auto-strategy scrambled-grid re-sort attempt
# (mirrors GraphDecomposition's single-device gate): below this, the O(nnz)
# double permutation + second banded_split cost more than the banded path
# saves, and a genuinely irregular graph would pay that analysis per solve.
RESORT_MIN_SPOTS = 8192


def default_mesh(n_shards: Optional[int] = None) -> Mesh:
    """1-D mesh over the first ``n_shards`` local devices (all by default)."""
    devices = jax.devices()
    if n_shards is None:
        n_shards = len(devices)
    if n_shards > len(devices):
        raise ValueError(
            f"Requested {n_shards} shards but only {len(devices)} devices "
            f"are visible."
        )
    return Mesh(np.asarray(devices[:n_shards]), (_AXIS,))


def _halo_exchange(beta_loc: jnp.ndarray, send_idx: jnp.ndarray) -> jnp.ndarray:
    """Publish this shard's boundary rows; return the pooled global buffer.

    beta_loc : (shard_size, K); send_idx : (halo_width,) local rows with
    padding == shard_size (maps to an appended zero row).
    Returns (n_shards * halo_width, K).
    """
    zero = jnp.zeros((1, beta_loc.shape[1]), dtype=beta_loc.dtype)
    boundary = jnp.take(
        jnp.concatenate([beta_loc, zero], axis=0), send_idx, axis=0
    )
    pool = lax.all_gather(boundary, _AXIS, tiled=True)
    return pool


def _sharded_sweep(beta_loc, Xty_loc, XtX, nbr_loc, nnb_loc, mask_loc,
                   send_idx, lambda_, rho):
    """One BCD sweep of this shard's spots, incl. halo exchange and stats."""
    pool = _halo_exchange(beta_loc, send_idx)
    zero = jnp.zeros((1, beta_loc.shape[1]), dtype=beta_loc.dtype)
    beta_ext = jnp.concatenate([beta_loc, pool, zero], axis=0)
    nbr_sum = neighbor_sum(beta_ext, nbr_loc)

    beta_new = coordinate_descent(
        beta_loc, Xty_loc, XtX, nbr_sum, nnb_loc, lambda_, rho
    )
    beta_new = jnp.where(mask_loc[:, None], beta_new, 0.0)

    loc_diff, loc_abs = sweep_stats(beta_new, beta_loc, mask_loc)
    return beta_new, lax.pmax(loc_diff, _AXIS), lax.pmax(loc_abs, _AXIS)


def _sharded_iterate(beta_loc, Xty_loc, XtX, nbr_loc, nnb_loc, mask_loc,
                     send_idx, lambda_, rho, tol, iter_cap,
                     max_iter: int):
    """Per-shard body of the fused solve loop (runs inside shard_map).

    Convergence semantics match the reference driver
    (``flashdeconv/core/solver.py:385-413``): stop when
    global_max_diff / (global_max_abs + 1e-10) < tol. ``iter_cap`` is a
    *traced* chunk bound (see :func:`ops.bcd.converge_loop`) so the verbose
    chunked driver reuses the same executable.
    """
    return converge_loop(
        lambda beta: _sharded_sweep(
            beta, Xty_loc, XtX, nbr_loc, nnb_loc, mask_loc, send_idx,
            lambda_, rho,
        ),
        beta_loc, tol, max_iter, iter_cap=iter_cap,
    )


@partial(jax.jit, static_argnames=("mesh", "max_iter"))
def _sharded_solve_jit(beta0, Xty, XtX, nbr, nnb, mask, send_idx,
                       lambda_, rho, tol, iter_cap, mesh: Mesh,
                       max_iter: int):
    shard = P(_AXIS)
    repl = P()
    fn = jax.shard_map(
        partial(_sharded_iterate, max_iter=max_iter),
        mesh=mesh,
        in_specs=(shard, shard, repl, shard, shard, shard, shard,
                  repl, repl, repl, repl),
        out_specs=(shard, repl, repl),
    )
    return fn(beta0, Xty, XtX, nbr, nnb, mask, send_idx, lambda_, rho, tol,
              iter_cap)


def _sharded_objective(beta_loc, Xty_loc, XtX, nbr_loc, nnb_loc, send_idx,
                       YtY, lambda_, rho):
    """Per-shard objective terms, globally reduced with ``psum``.

    Same algebra as :func:`flashdeconv_tpu.ops.bcd.objective_terms`
    (fidelity via the precomputed expansions, spatial via the D - A
    neighbor-table expansion); padded rows hold zero beta/Xty/nnb and
    contribute nothing. Device-side so atlas-scale sharded runs never pay
    the host (K, N) matmul + Laplacian build per objective sample.
    """
    pool = _halo_exchange(beta_loc, send_idx)
    zero = jnp.zeros((1, beta_loc.shape[1]), dtype=beta_loc.dtype)
    beta_ext = jnp.concatenate([beta_loc, pool, zero], axis=0)
    ns = neighbor_sum(beta_ext, nbr_loc)

    cross = lax.psum(jnp.sum(beta_loc * Xty_loc), _AXIS)
    BtB = lax.psum(
        jnp.dot(beta_loc.T, beta_loc, precision=lax.Precision.HIGHEST), _AXIS
    )
    quad = jnp.sum(BtB * XtX)
    fidelity = 0.5 * (YtY - 2.0 * cross + quad)

    deg_term = lax.psum(
        jnp.sum(nnb_loc * jnp.sum(beta_loc * beta_loc, axis=1)), _AXIS
    )
    adj_term = lax.psum(jnp.sum(beta_loc * ns), _AXIS)
    spatial = 0.5 * lambda_ * (deg_term - adj_term)

    sparsity = rho * lax.psum(jnp.sum(jnp.abs(beta_loc)), _AXIS)
    return fidelity + spatial + sparsity


@partial(jax.jit, static_argnames=("mesh",))
def _sharded_objective_jit(beta, Xty, XtX, nbr, nnb, send_idx, YtY,
                           lambda_, rho, mesh: Mesh):
    shard = P(_AXIS)
    repl = P()
    fn = jax.shard_map(
        _sharded_objective,
        mesh=mesh,
        in_specs=(shard, shard, repl, shard, shard, shard,
                  repl, repl, repl),
        out_specs=repl,
    )
    return fn(beta, Xty, XtX, nbr, nnb, send_idx, YtY, lambda_, rho)


def sharded_bcd_solve(
    Y_sketch: np.ndarray,
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    lambda_: float = 0.1,
    rho: float = 0.01,
    max_iter: int = 100,
    tol: float = 1e-4,
    coords: Optional[np.ndarray] = None,
    mesh: Optional[Mesh] = None,
    n_shards: Optional[int] = None,
    plan: Optional[ShardPlan] = None,
    order: str = "morton",
    verbose: bool = False,
    dtype=np.float32,
    beta_init: Optional[np.ndarray] = None,
    strategy: str = "auto",
) -> Tuple[np.ndarray, dict]:
    """Multi-device BCD solve; drop-in for :func:`core.solver.bcd_solve`.

    Two interchangeable (numerically identical) execution strategies:

    - ``"halo"`` — explicit plan: Morton-ordered contiguous shards, per-sweep
      boundary-row ``all_gather`` under ``shard_map`` (any graph).
    - ``"banded"`` — GSPMD: static banded shifts over spot-sharded global
      arrays, compiler-inserted halo collectives
      (:mod:`flashdeconv_tpu.parallel.gspmd`; fully banded graphs only).
    - ``"auto"`` (default) — banded when the graph is fully banded (grid
      platforms), else halo.

    Returns beta in the original spot order with the standard ``info``
    contract.

    Objective precision: ``final_objective`` / ``objectives`` are evaluated
    on device in the solver ``dtype`` (YtY included), matching the
    single-device driver. An f32 solve therefore reports the objective with
    f32 quantization (~1e-7 relative — at atlas scale a few tens absolute
    out of YtY ~ 1e8); pass ``dtype=np.float64`` when exact-parity
    objective reporting matters (the f64 trajectory tests do).
    """
    n_spots = Y_sketch.shape[0]
    n_types = X_sketch.shape[0]

    if strategy not in ("auto", "halo", "banded"):
        raise ValueError(f"Unknown strategy: {strategy!r}")
    if strategy == "banded" and plan is not None:
        raise ValueError(
            "strategy='banded' does not use a ShardPlan; pass plan only "
            "with strategy='halo' (or 'auto', which skips the banded path "
            "when a plan is given)."
        )
    if n_spots == 0 or n_types == 0 or max_iter == 0:
        beta = np.full((n_spots, n_types), 1.0 / max(n_types, 1))
        if n_spots == 0 or n_types == 0:
            beta = np.empty((n_spots, n_types))
        if n_shards is None:
            n_shards = (
                int(mesh.devices.size) if mesh is not None
                else len(jax.devices())
            )
        # Same info-key contract as every non-degenerate sharded return
        # (a caller logging shard metadata must not KeyError here).
        return beta, {
            "converged": n_spots == 0 or n_types == 0,
            "n_iterations": 0,
            "final_objective": 0.0,
            "objectives": [],
            "final_change": 0.0,
            "n_shards": int(n_shards),
            "halo_width": 0,
        }

    problem = prepare_sharded_bcd(
        Y_sketch, X_sketch, A, coords=coords, mesh=mesh, n_shards=n_shards,
        plan=plan, order=order, dtype=dtype, strategy=strategy,
        verbose=verbose,
    )
    return problem.solve(
        lambda_=lambda_, rho=rho, max_iter=max_iter, tol=tol,
        verbose=verbose, beta_init=beta_init,
    )


class HaloShardedProblem:
    """Prepared halo-plan problem: graph partition, host precompute
    (XtX / YtY / Xty) and the device scatter of every beta-independent
    operand run ONCE in the constructor; each :meth:`solve` reuses the
    resident sharded arrays and pays only the per-solve scalars plus the
    fused device loop. The irregular-graph counterpart of
    :class:`flashdeconv_tpu.parallel.gspmd.GspmdBandedProblem`.

    ``xty`` / ``yty`` optionally supply ``Y_sketch @ X_sketch.T`` and the
    Frobenius constant precomputed elsewhere (the solver consumes the
    sketch only through these two reductions) — with both given,
    ``Y_sketch`` may be None and is never touched.
    """

    def __init__(
        self,
        Y_sketch: Optional[np.ndarray],
        X_sketch: np.ndarray,
        A: sparse.spmatrix,
        coords: Optional[np.ndarray] = None,
        mesh: Optional[Mesh] = None,
        n_shards: Optional[int] = None,
        plan: Optional[ShardPlan] = None,
        order: str = "morton",
        dtype=np.float32,
        verbose: bool = False,
        xty: Optional[np.ndarray] = None,
        yty: Optional[float] = None,
    ):
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

        if mesh is None:
            mesh = default_mesh(n_shards)
        self.mesh = mesh
        self.n_shards = mesh.devices.size

        if plan is None:
            plan = plan_shards(A, self.n_shards, coords=coords, order=order)
        self.plan = plan
        if verbose:
            from flashdeconv_tpu.parallel.partition import halo_fraction

            print(
                f"Sharded solve: {self.n_shards} shards x {plan.shard_size} "
                f"spots, halo width {plan.halo_width} "
                f"({100 * halo_fraction(plan):.2f}% of rows exchanged/sweep)"
            )

        from flashdeconv_tpu.core.solver import (
            precompute_gram_matrix,
            sanitize_xty_rows,
            sanitize_yty,
        )

        XtX64 = precompute_gram_matrix(np.asarray(X_sketch, np.float64))
        YtY = sanitize_yty(yty, Y_sketch)
        self.rho_scale = float(np.mean(np.diag(XtX64)))

        if xty is not None:
            Xty_np = np.ascontiguousarray(xty, dtype=dtype)
        else:
            Xty_np = np.ascontiguousarray(Y_sketch @ X_sketch.T, dtype=dtype)
        # Host-side non-finite guard (BEFORE the halo scatter so boundary
        # copies match); semantics in core.solver.sanitize_xty_rows.
        Xty_np, self.n_nonfinite_spots = sanitize_xty_rows(Xty_np)
        Xty = plan.scatter(Xty_np)

        self._shard = NamedSharding(mesh, P(_AXIS))
        self._repl = NamedSharding(mesh, P())
        put = self._put
        self.Xty_d = put(Xty, self._shard)
        self.nbr_d = put(plan.nbr_idx, self._shard)
        self.nnb_d = put(plan.n_nbrs.astype(dtype), self._shard)
        self.mask_d = put(plan.spot_mask, self._shard)
        self.send_d = put(plan.send_idx, self._shard)
        self.XtX_d = put(XtX64.astype(dtype), self._repl)
        self.YtY_d = put(np.asarray(YtY, dtype=dtype), self._repl)
        # Default uniform init, built lazily on the first no-init solve and
        # then kept resident (the solve loop does not donate its inputs) —
        # warm-start-only workloads never pay the (n_pad, K) residency.
        self._beta0_uniform_d = None

    def _put(self, arr, sharding):
        return put_addressable(arr, sharding)

    def _beta0_default(self):
        if self._beta0_uniform_d is None:
            plan, n_types, dtype = self.plan, self.n_types, self.dtype
            beta0 = np.where(
                plan.spot_mask[:, None],
                np.asarray(1.0 / n_types, dtype=dtype), 0.0,
            ).astype(dtype)
            beta0 = np.broadcast_to(beta0, (plan.n_padded, n_types)).copy()
            self._beta0_uniform_d = self._put(beta0, self._shard)
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
        n_spots, n_types = self.n_spots, self.n_types
        dtype = self.dtype
        plan, mesh = self.plan, self.mesh
        if max_iter == 0:
            beta = np.full((n_spots, n_types), 1.0 / max(n_types, 1))
            return beta, {
                "converged": False,
                "n_iterations": 0,
                "final_objective": 0.0,
                "objectives": [],
                "final_change": 0.0,
                "n_shards": self.n_shards,
                "halo_width": plan.halo_width,
            }

        validate_beta_init(beta_init, n_spots, n_types)
        if beta_init is not None:
            beta0 = plan.scatter(
                np.ascontiguousarray(np.maximum(beta_init, 0.0), dtype=dtype)
            )
            beta0_d = self._put(beta0, self._shard)
        else:
            beta0_d = self._beta0_default()

        rho_eff = float(rho) * self.rho_scale
        lam_d = self._put(np.asarray(lambda_, dtype=dtype), self._repl)
        rho_d = self._put(np.asarray(rho_eff, dtype=dtype), self._repl)
        tol_d = self._put(np.asarray(tol, dtype=dtype), self._repl)

        def run_chunk(beta_d, cap):
            return _sharded_solve_jit(
                beta_d, self.Xty_d, self.XtX_d, self.nbr_d, self.nnb_d,
                self.mask_d, self.send_d, lam_d, rho_d, tol_d, cap, mesh,
                max_iter,
            )

        def eval_objective(beta_d):
            return _sharded_objective_jit(
                beta_d, self.Xty_d, self.XtX_d, self.nbr_d, self.nnb_d,
                self.send_d, self.YtY_d, lam_d, rho_d, mesh,
            )

        beta_pad, n_iter, rel_change, final_obj, converged, objectives = (
            run_prepared_solve(
                run_chunk, eval_objective, beta0_d, max_iter, tol, verbose,
                return_device=return_device,
            )
        )
        if return_device:
            # Device-side inverse of plan.scatter: un-permute the Morton
            # row order with a gather (the host copy never materializes).
            beta = device_unpermute(
                self, beta_pad[:n_spots], plan.perm, n_spots
            )
        else:
            beta = plan.gather(beta_pad)

        info = {
            "converged": converged,
            "n_iterations": n_iter,
            "final_objective": final_obj,
            "objectives": objectives,
            "final_change": rel_change,
            "n_shards": self.n_shards,
            "halo_width": plan.halo_width,
        }
        return beta, info


class ShardedBCDProblem:
    """Strategy-dispatched prepared sharded problem.

    Wraps a :class:`GspmdBandedProblem` (grid platforms) or a
    :class:`HaloShardedProblem` (irregular graphs), plus the optional
    scrambled-grid re-sort permutation applied at prepare time — beta
    always enters and leaves :meth:`solve` in the ORIGINAL spot order.
    Built by :func:`prepare_sharded_bcd`; used by
    ``FlashDeconv.fit_lambda_path`` on a mesh so the per-solve cost is
    device-only, mirroring :class:`flashdeconv_tpu.core.solver.BCDProblem`.
    """

    def __init__(self, inner, perm: Optional[np.ndarray] = None):
        self._inner = inner
        self._perm = perm

    @property
    def strategy(self) -> str:
        from flashdeconv_tpu.parallel.gspmd import GspmdBandedProblem

        return (
            "banded" if isinstance(self._inner, GspmdBandedProblem)
            else "halo"
        )

    @property
    def n_spots(self) -> int:
        return self._inner.n_spots

    @property
    def n_types(self) -> int:
        return self._inner.n_types

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
        perm = self._perm
        validate_beta_init(beta_init, self.n_spots, self.n_types)
        if beta_init is not None and perm is not None:
            beta_init = beta_init[perm]
        beta, info = self._inner.solve(
            lambda_=lambda_, rho=rho, max_iter=max_iter, tol=tol,
            verbose=verbose, beta_init=beta_init,
            return_device=return_device,
        )
        if perm is not None:
            if return_device:
                beta = device_unpermute(self, beta, perm, self.n_spots)
            else:
                out = np.empty_like(beta)
                out[perm] = beta
                beta = out
        return beta, info


def prepare_sharded_bcd(
    Y_sketch: Optional[np.ndarray],
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    coords: Optional[np.ndarray] = None,
    mesh: Optional[Mesh] = None,
    n_shards: Optional[int] = None,
    plan: Optional[ShardPlan] = None,
    order: str = "morton",
    dtype=np.float32,
    strategy: str = "auto",
    verbose: bool = False,
    xty: Optional[np.ndarray] = None,
    yty: Optional[float] = None,
) -> ShardedBCDProblem:
    """Build a :class:`ShardedBCDProblem`: strategy dispatch, graph
    analysis / partition, host precompute, and device scatter — once.

    Strategy resolution matches :func:`sharded_bcd_solve`: ``"banded"``
    when the adjacency is fully banded within 32 offsets (optionally after
    the scrambled-grid re-sort, for ``"auto"`` with coords at
    >= ``RESORT_MIN_SPOTS`` spots), else the explicit ``"halo"`` plan.

    ``xty`` / ``yty`` optionally supply the ``Y_sketch @ X_sketch.T``
    product and Frobenius constant (e.g. from
    ``native.fused_log1pcpm_xty``); with both given, ``Y_sketch`` may be
    None — the sharded solvers consume the sketch only through these two
    reductions.
    """
    if strategy not in ("auto", "halo", "banded"):
        raise ValueError(f"Unknown strategy: {strategy!r}")
    if strategy == "banded" and plan is not None:
        raise ValueError(
            "strategy='banded' does not use a ShardPlan; pass plan only "
            "with strategy='halo' (or 'auto', which skips the banded path "
            "when a plan is given)."
        )
    if Y_sketch is None and (xty is None or yty is None):
        raise ValueError(
            "Y_sketch=None requires both xty and yty precomputed "
            "(the sharded solvers consume the sketch only through these "
            "two reductions)."
        )
    n_spots = int(
        Y_sketch.shape[0] if Y_sketch is not None else np.shape(xty)[0]
    )
    n_types = int(X_sketch.shape[0])
    if n_spots == 0 or n_types == 0:
        raise ValueError(
            "prepare_sharded_bcd requires a non-empty problem "
            f"(got {n_spots} spots x {n_types} cell types)."
        )

    if strategy in ("auto", "banded") and plan is None:
        from flashdeconv_tpu.parallel.gspmd import GspmdBandedProblem
        from flashdeconv_tpu.utils.graph import banded_split

        # min_coverage=1.0 makes this a cheap pre-check: the (U, N) masks
        # are only materialized when the graph really is 100% banded (the
        # offset histogram + coverage test run first and bail otherwise),
        # so an irregular graph never pays for masks it would discard.
        split = banded_split(A, max_offsets=32, min_coverage=1.0)
        offsets_chk, _, A_rest_chk = split
        fully_banded = A.nnz == 0 or (
            offsets_chk.size > 0 and A_rest_chk.nnz == 0
        )
        if (
            not fully_banded
            and coords is not None
            and strategy == "auto"
            and n_spots >= RESORT_MIN_SPOTS
        ):
            # Scrambled-grid re-sort: a shuffled grid / hex lattice becomes
            # fully banded under a row-major (y, x) sort (mirrors the
            # single-device driver's re-sort, including its size gate — see
            # RESORT_MIN_SPOTS). The permutation is applied once here; beta
            # enters/leaves solve() in the original order.
            c = np.asarray(coords)
            if c.ndim == 2 and c.shape[1] >= 2:
                cand = np.lexsort((c[:, 0], c[:, 1]))
                A_cand = A.tocsr()[cand][:, cand]
                split_c = banded_split(
                    A_cand, max_offsets=32, min_coverage=1.0
                )
                if split_c[0].size > 0 and split_c[2].nnz == 0:
                    if mesh is None:
                        mesh = default_mesh(n_shards)
                    inner = GspmdBandedProblem(
                        Y_sketch[cand] if Y_sketch is not None else None,
                        X_sketch, A_cand, mesh=mesh, dtype=dtype,
                        verbose=verbose, _split=split_c,
                        xty=xty[cand] if xty is not None else None,
                        yty=yty,
                    )
                    return ShardedBCDProblem(inner, perm=cand)
        if strategy == "banded" or fully_banded:
            if mesh is None:
                mesh = default_mesh(n_shards)
            inner = GspmdBandedProblem(
                Y_sketch, X_sketch, A, mesh=mesh, dtype=dtype,
                verbose=verbose, _split=split, xty=xty, yty=yty,
            )
            return ShardedBCDProblem(inner)

    inner = HaloShardedProblem(
        Y_sketch, X_sketch, A, coords=coords, mesh=mesh, n_shards=n_shards,
        plan=plan, order=order, dtype=dtype, verbose=verbose, xty=xty,
        yty=yty,
    )
    return ShardedBCDProblem(inner)
