"""Device kernels for the block-coordinate-descent deconvolution solve.

Vectorized reformulation of the reference's Numba sweep (reference
``flashdeconv/core/solver.py:29-184``): the reference runs a *sequential*
Gauss-Seidel loop over K cell types inside each spot while sweeping spots in
parallel with Jacobi neighbor reads. Here the spot axis is fully vectorized —
coordinate k is updated for **all spots at once** as (N,)-wide elementwise
ops, and the maintained residual ``r = beta @ XtX`` is updated with a rank-1
outer product per coordinate. This preserves the reference's iterate path
exactly (Gauss-Seidel within spot, Jacobi across spots). On GPUs the f32
grid and gather sweeps run as one Pallas kernel instead
(:mod:`flashdeconv_tpu.ops.sweep_kernel`); this module is the XLA path for
every other case and the float64 reference path.

Data layout: the spatial graph is a padded neighbor table ``nbr_idx`` of
shape (N, max_deg) whose padding slots point at an all-zero sentinel row
appended to beta, so masked neighbor sums need no branching.

All functions are shape-polymorphic pure JAX and are reused verbatim inside
``shard_map`` by the distributed solver (:mod:`flashdeconv_tpu.parallel`).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

# Unroll the coordinate loop at trace time up to this many cell types: K is
# static and small, and unrolled static slices compile to much tighter code
# than a fori_loop with dynamic slices. The cap exists for COMPILE time,
# not numerics: the fori_loop tier is bitwise-identical (pinned by
# tests/test_reference_parity.py::test_fori_loop_tier_bitwise_equals_
# unrolled), but unrolling K~130-160 coordinate updates into a 1M-spot
# banded while-loop body compiles for tens of minutes where the rolled form
# compiles in seconds. 64 covers every realistic cell-type panel on the
# unrolled fast path.
_UNROLL_MAX_K = 64

# Full-f32 precision for the (tiny) solver matmuls: residual maintenance
# subtracts quantities of similar magnitude (Xty - r), so reduced-precision
# products (bf16 passes, or TF32 on GPU tensor cores) would inject ~1e-3 to
# 1e-2 relative noise into the iterate path. These matmuls are O(N*K^2) —
# negligible next to the neighbor sums — so exactness is free.
_PREC = lax.Precision.HIGHEST


def soft_threshold(x, threshold):
    """Elementwise soft-thresholding prox for the L1 penalty."""
    return jnp.sign(x) * jnp.maximum(jnp.abs(x) - threshold, 0.0)


def neighbor_sum(beta_ext: jnp.ndarray, nbr_idx: jnp.ndarray) -> jnp.ndarray:
    """Sum of beta rows over each spot's (padded) neighbor list.

    Parameters
    ----------
    beta_ext : (M, K) — beta rows indexable by every entry of ``nbr_idx``;
        padding entries must point at all-zero rows of this buffer.
    nbr_idx : (N, max_deg) int32

    Returns
    -------
    (N, K) neighbor sums.

    The gather is accumulated one degree-slot at a time (max_deg is a small
    static constant) to avoid materializing an (N, max_deg, K) temporary.
    """
    max_deg = nbr_idx.shape[1]
    acc = jnp.take(beta_ext, nbr_idx[:, 0], axis=0)
    for d in range(1, max_deg):
        acc = acc + jnp.take(beta_ext, nbr_idx[:, d], axis=0)
    return acc


def overflow_sum(
    beta_ext: jnp.ndarray,
    ov_src: jnp.ndarray,
    ov_dst: jnp.ndarray,
    n_spots: int,
) -> jnp.ndarray:
    """Neighbor-sum contribution of overflow edges (degree-capped graphs).

    When the padded neighbor table is capped at a quantile degree
    (:func:`flashdeconv_tpu.utils.graph.adjacency_to_padded_capped`), the few
    edges of pathological hub spots that do not fit are carried as an edge
    list and accumulated here with one deterministic ``segment_sum`` —
    keeping solver memory O(N * cap) regardless of the max degree, the role
    CSR plays in the reference (reference
    ``flashdeconv/core/solver.py:363-365``).

    Parameters
    ----------
    beta_ext : (M, K) — beta with the zero sentinel row appended
    ov_src : (E,) int32 destination spot of each overflow edge
    ov_dst : (E,) int32 neighbor index (gathers from ``beta_ext``)
    n_spots : static int, number of output rows
    """
    contrib = jnp.take(beta_ext, ov_dst, axis=0)
    return jax.ops.segment_sum(contrib, ov_src, num_segments=n_spots)


def neighbor_sum_banded(
    beta: jnp.ndarray,
    offsets: Tuple[int, ...],
    masks: jnp.ndarray,
    rest_nbr_idx: jnp.ndarray,
    halo: int,
) -> jnp.ndarray:
    """Neighbor sum over a banded + remainder adjacency decomposition.

    The banded part (:func:`flashdeconv_tpu.utils.graph.banded_split`) turns
    each diagonal offset into a contiguous shifted slice of beta times a
    per-spot 0/1 mask — streaming reads instead of the random row gather.
    Remainder edges (irregular boundary
    cases) still go through the padded-table gather; on grid data they are
    typically none.

    Parameters
    ----------
    beta : (N, K)
    offsets : static tuple of ints — diagonal offsets (|o| <= ``halo``).
        Static so the shifts are *static* slices: XLA fuses them into one
        streaming pass, and under GSPMD a spot-sharded beta turns each shift
        into a neighbor-shard halo exchange instead of an all-gather.
    masks : (U, N) 0/1 edge-exists mask per offset (uint8 or float)
    rest_nbr_idx : (N, R) int32 padded table (R may be 0); padding == N
    halo : static int, max |offset| (pad width)
    """
    n = beta.shape[0]
    ns = jnp.zeros_like(beta)
    if len(offsets) > 0:
        beta_pad = jnp.pad(beta, ((halo, halo), (0, 0)))
        for u, off in enumerate(offsets):
            sl = lax.slice_in_dim(beta_pad, halo + off, halo + off + n, axis=0)
            ns = ns + masks[u][:, None] * sl
    if rest_nbr_idx.shape[1] > 0:
        zero_row = jnp.zeros((1, beta.shape[1]), dtype=beta.dtype)
        beta_ext = jnp.concatenate([beta, zero_row], axis=0)
        ns = ns + neighbor_sum(beta_ext, rest_nbr_idx)
    return ns


def _coord_update(beta, r, k, Xty, XtX, nbr_sum, n_nbrs, lambda_, rho, static: bool):
    """Gauss-Seidel update of coordinate k for every spot simultaneously.

    Solves the 1-D subproblem of
    0.5*||y_i - beta_i X||^2 + 0.5*lambda*sum_j ||beta_i - beta_j||^2 + rho*|beta_ik|
    with all other coordinates fixed, using the maintained residual
    r_i = XtX @ beta_i (updated rank-1 after the coordinate moves).
    """
    if static:
        old = beta[:, k : k + 1]                     # (N, 1)
        r_k = r[:, k : k + 1]
        xty_k = Xty[:, k : k + 1]
        ns_k = nbr_sum[:, k : k + 1]
        diag_k = XtX[k, k]
        row_k = XtX[k : k + 1, :]                    # (1, K)
    else:
        old = lax.dynamic_slice_in_dim(beta, k, 1, axis=1)
        r_k = lax.dynamic_slice_in_dim(r, k, 1, axis=1)
        xty_k = lax.dynamic_slice_in_dim(Xty, k, 1, axis=1)
        ns_k = lax.dynamic_slice_in_dim(nbr_sum, k, 1, axis=1)
        row_k = lax.dynamic_slice_in_dim(XtX, k, 1, axis=0)
        diag_k = lax.dynamic_slice(row_k, (0, k), (1, 1))[0, 0]

    # Partial residual excluding coordinate k's own contribution, plus the
    # spatial attraction toward the neighbor mean.
    resid = xty_k - r_k + diag_k * old + lambda_ * ns_k
    denom = diag_k + lambda_ * n_nbrs[:, None]
    # soft-threshold then clamp at zero == relu(resid - rho) / denom for rho>=0
    new = jnp.where(
        denom > 1e-10, jnp.maximum(resid - rho, 0.0) / denom, jnp.zeros_like(old)
    )
    delta = new - old
    # rank-1 residual refresh
    r = r + jnp.dot(delta, row_k, precision=_PREC)
    if static:
        beta = beta.at[:, k : k + 1].set(new)
    else:
        beta = lax.dynamic_update_slice_in_dim(beta, new, k, axis=1)
    return beta, r


def coordinate_descent(
    beta: jnp.ndarray,
    Xty: jnp.ndarray,
    XtX: jnp.ndarray,
    nbr_sum: jnp.ndarray,
    n_nbrs: jnp.ndarray,
    lambda_,
    rho,
) -> jnp.ndarray:
    """One full Gauss-Seidel pass over the K coordinates of every spot.

    beta (N, K) is the Jacobi read buffer already used for ``nbr_sum``; the
    returned array is the updated buffer.
    """
    K = beta.shape[1]
    # (N, K) maintained residual, one matmul
    r = jnp.dot(beta, XtX, precision=_PREC)

    if K <= _UNROLL_MAX_K:
        for k in range(K):
            beta, r = _coord_update(
                beta, r, k, Xty, XtX, nbr_sum, n_nbrs, lambda_, rho, static=True
            )
        return beta

    def body(k, carry):
        b, rr = carry
        return _coord_update(
            b, rr, k, Xty, XtX, nbr_sum, n_nbrs, lambda_, rho, static=False
        )

    beta, _ = lax.fori_loop(0, K, body, (beta, r))
    return beta


def iterate(
    beta0, operands, lambda_, rho, tol, iter_cap,
    tier: str, offsets: Optional[Tuple[int, ...]], halo: int,
    max_iter: int, kernel: bool, interpret: bool = False,
):
    """Solve loop of one tier over a dict of prepared device operands.

    ``operands`` holds ``Xty``/``XtX``/``nnb`` plus, for ``tier="banded"``,
    ``masks`` (uint8 or float 0/1) and ``rest`` (padded remainder table);
    for ``tier="gather"``, ``nbr`` and optional ``ov_src``/``ov_dst``.
    ``kernel=True`` runs the sweep as the GPU Pallas kernel
    (:func:`flashdeconv_tpu.ops.sweep_kernel.bcd_iterate_kernel`; the
    gather tier passes the whole padded table as the kernel's remainder and
    must carry no overflow edges), else the XLA sweeps. Returns
    ``(beta, n_iter, rel_change)``.
    """
    Xty, XtX, nnb = operands["Xty"], operands["XtX"], operands["nnb"]
    if kernel:
        from flashdeconv_tpu.ops.sweep_kernel import bcd_iterate_kernel

        if tier == "banded":
            offs, masks, rest = offsets, operands["masks"], operands["rest"]
        else:
            if "ov_src" in operands:
                raise ValueError(
                    "the sweep kernel reads neighbours only from its tables; "
                    "a gather table with overflow edges needs the XLA tier"
                )
            offs, masks, rest = (), None, operands["nbr"]
        return bcd_iterate_kernel(
            beta0, Xty, XtX, nnb, lambda_, rho, tol, max_iter,
            offsets=offs, masks=masks, rest=rest, iter_cap=iter_cap,
            interpret=interpret,
        )
    if tier == "banded":
        return bcd_iterate_banded(
            beta0, Xty, XtX, offsets, operands["masks"], operands["rest"],
            nnb, lambda_, rho, tol, max_iter, halo, iter_cap=iter_cap,
        )
    return bcd_iterate(
        beta0, Xty, XtX, operands["nbr"], nnb, lambda_, rho, tol, max_iter,
        iter_cap=iter_cap, ov_src=operands.get("ov_src"),
        ov_dst=operands.get("ov_dst"),
    )


def objective(beta, operands, lambda_, rho, tier: str,
              offsets: Optional[Tuple[int, ...]], halo: int):
    """Objective of one tier over the same operands dict as :func:`iterate`."""
    if tier == "banded":
        return objective_terms_banded(
            beta, operands["Xty"], operands["XtX"], operands["YtY"], offsets,
            operands["masks"], operands["rest"], operands["nnb"],
            lambda_, rho, halo,
        )
    return objective_terms_jit(
        beta, operands["Xty"], operands["XtX"], operands["YtY"],
        operands["nbr"], operands["nnb"], lambda_, rho,
        ov_src=operands.get("ov_src"), ov_dst=operands.get("ov_dst"),
    )


@partial(
    jax.jit,
    static_argnames=("tier", "offsets", "halo", "max_iter", "kernel",
                     "n_spots", "interpret"),
)
def solve_program(
    beta0, operands, inv_perm, lambda_, rho, tol, iter_cap,
    tier: str, offsets: Optional[Tuple[int, ...]], halo: int,
    max_iter: int, kernel: bool, n_spots: int, interpret: bool = False,
):
    """The whole solve as ONE compiled program: converge loop + final
    objective + un-pad + un-permute in a single dispatch, returning
    ``(beta (n_spots, K), n_iter, rel_change, objective)``.

    ``operands``, ``tier`` and ``kernel`` are as in :func:`iterate`.
    ``beta0`` may be None (uniform 1/K over the first ``n_spots`` rows,
    built on device); ``inv_perm`` may be None (identity).
    """
    Xty = operands["Xty"]
    if beta0 is None:
        n_solve, K = Xty.shape
        beta0 = jnp.zeros((n_solve, K), dtype=Xty.dtype)
        beta0 = beta0.at[:n_spots].set(1.0 / K)
    beta, n_iter, rel = iterate(
        beta0, operands, lambda_, rho, tol, iter_cap, tier, offsets, halo,
        max_iter, kernel, interpret=interpret,
    )
    obj = objective(beta, operands, lambda_, rho, tier, offsets, halo)
    beta = beta[:n_spots]
    if inv_perm is not None:
        beta = jnp.take(beta, inv_perm, axis=0)
    return beta, n_iter, rel, obj


def sweep_stats(
    beta_out: jnp.ndarray,
    beta_in: jnp.ndarray,
    spot_mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fused convergence statistics of one sweep: (max |delta|, max |old|).

    Matches the reference's per-sweep reduction (reference
    ``flashdeconv/core/solver.py:173-183``); masked rows (padding) are
    excluded.
    """
    diffs = jnp.max(jnp.abs(beta_out - beta_in), axis=1)
    abs_old = jnp.max(jnp.abs(beta_in), axis=1)
    if spot_mask is not None:
        diffs = jnp.where(spot_mask, diffs, 0.0)
        abs_old = jnp.where(spot_mask, abs_old, 0.0)
    return jnp.max(diffs), jnp.max(abs_old)


def converge_loop(sweep_fn, beta0, tol, max_iter: int, iter_cap=None):
    """Fused solve loop shared by every solver variant.

    ``sweep_fn(beta) -> (beta_new, max_diff, max_abs)``. Stops when
    max_diff / (max_abs + 1e-10) < tol (reference convergence rule,
    ``flashdeconv/core/solver.py:385-413``); the satisfying sweep is still
    applied. Returns (beta, n_iterations, rel_change).

    ``max_iter`` is the static (compile-time) bound; ``iter_cap`` is an
    optional *traced* bound so callers can run shorter chunks without
    recompiling (e.g. the verbose driver's tail chunk). The convergence
    scalars take beta's dtype.
    """
    big = jnp.asarray(jnp.inf, dtype=beta0.dtype)

    def cond(carry):
        _, it, rel = carry
        go = jnp.logical_and(it < max_iter, rel >= tol)
        if iter_cap is not None:
            go = jnp.logical_and(go, it < iter_cap)
        return go

    def body(carry):
        beta, it, _ = carry
        beta_new, max_diff, max_abs = sweep_fn(beta)
        rel = max_diff / (max_abs + 1e-10)
        return beta_new, it + 1, rel

    return lax.while_loop(cond, body, (beta0, jnp.int32(0), big))


def chunked_verbose_solve(run_chunk, eval_objective, beta0, max_iter: int,
                          tol: float, log=print):
    """Host-chunked fused loop on the reference logging cadence.

    Shared by every solver variant's ``verbose=True`` path: runs the fused
    device loop in chunks whose boundaries land on the reference's objective
    cadence (after sweeps 0, 10, 20, ..., reference
    ``flashdeconv/core/solver.py:399-404``) so the trajectory is observable
    without a host round-trip per sweep. One divergence from the reference:
    when the solve converges mid-chunk, the objective is also sampled at the
    converged sweep.

    Parameters
    ----------
    run_chunk : callable(beta, cap_traced) -> (beta, n_done, rel_change) —
        the jitted fused loop with a *traced* iteration cap (same compiled
        executable as the non-verbose full solve).
    eval_objective : callable(beta) -> jax scalar (async-dispatched).
    beta0 : initial device buffer.
    max_iter, tol : solve budget and stopping rule.

    Returns (beta, n_iter, rel_change, converged, objectives).
    """
    objectives: list = []
    beta_d = beta0
    converged = False
    rel_change = float("inf")
    n_iter = 0
    next_chunk = 1  # first boundary = sweep 0, then every 10
    while n_iter < max_iter:
        n_chunk = min(next_chunk, max_iter - n_iter)
        next_chunk = 10
        beta_d, it_d, rel_d = run_chunk(
            beta_d, jnp.asarray(n_chunk, dtype=jnp.int32)
        )
        rel_change = float(rel_d)
        n_iter += int(it_d)
        obj = float(eval_objective(beta_d))
        objectives.append(obj)
        log(
            f"Iteration {n_iter - 1}: objective = {obj:.6f}, "
            f"rel_change = {rel_change:.6e}"
        )
        if rel_change < tol:
            converged = True
            log(f"Converged at iteration {n_iter - 1}")
            break
    return beta_d, n_iter, rel_change, converged, objectives


def bcd_sweep(
    beta_in: jnp.ndarray,
    Xty: jnp.ndarray,
    XtX: jnp.ndarray,
    nbr_idx: jnp.ndarray,
    n_nbrs: jnp.ndarray,
    lambda_,
    rho,
    spot_mask: Optional[jnp.ndarray] = None,
    ov_src: Optional[jnp.ndarray] = None,
    ov_dst: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One BCD sweep with fused convergence statistics (single device).

    Parameters
    ----------
    beta_in : (N, K) current abundances (read-only Jacobi buffer)
    Xty : (N, K) precomputed Y_sketch @ X_sketch.T
    XtX : (K, K) Gram matrix of the sketched signatures
    nbr_idx : (N, max_deg) int32, padding slots == N (the sentinel row)
    n_nbrs : (N,) float, true neighbor counts
    spot_mask : optional (N,) bool — False rows are padding (sharded solver);
        their convergence stats are ignored.
    ov_src, ov_dst : optional (E,) int32 overflow edge lists for
        degree-capped neighbor tables (see :func:`overflow_sum`).

    Returns
    -------
    (beta_out (N, K), max_diff scalar, max_abs_old scalar)
    """
    zero_row = jnp.zeros((1, beta_in.shape[1]), dtype=beta_in.dtype)
    beta_ext = jnp.concatenate([beta_in, zero_row], axis=0)
    nbr_sum = neighbor_sum(beta_ext, nbr_idx)
    if ov_src is not None:
        nbr_sum = nbr_sum + overflow_sum(
            beta_ext, ov_src, ov_dst, beta_in.shape[0]
        )

    beta_out = coordinate_descent(
        beta_in, Xty, XtX, nbr_sum, n_nbrs, lambda_, rho
    )
    return (beta_out, *sweep_stats(beta_out, beta_in, spot_mask))


@partial(jax.jit, static_argnames=("max_iter",))
def bcd_iterate(
    beta0: jnp.ndarray,
    Xty: jnp.ndarray,
    XtX: jnp.ndarray,
    nbr_idx: jnp.ndarray,
    n_nbrs: jnp.ndarray,
    lambda_,
    rho,
    tol,
    max_iter: int,
    iter_cap=None,
    ov_src: Optional[jnp.ndarray] = None,
    ov_dst: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fused solve loop: sweeps until rel-change < tol or max_iter sweeps.

    Matches the reference driver semantics (reference
    ``flashdeconv/core/solver.py:385-413``): the convergence statistic of
    sweep t is max_i max_k |Delta beta| / (max_i max_k |beta_old| + 1e-10),
    and the sweep that satisfies it is still applied.

    Returns (beta, n_iterations, rel_change). Runs entirely on device inside
    one compiled while-loop — the host only sees the final state.
    """
    return converge_loop(
        lambda beta: bcd_sweep(
            beta, Xty, XtX, nbr_idx, n_nbrs, lambda_, rho,
            ov_src=ov_src, ov_dst=ov_dst,
        ),
        beta0, tol, max_iter, iter_cap=iter_cap,
    )


def objective_terms(
    beta: jnp.ndarray,
    Xty: jnp.ndarray,
    XtX: jnp.ndarray,
    YtY,
    nbr_idx: jnp.ndarray,
    n_nbrs: jnp.ndarray,
    lambda_,
    rho,
    ov_src: Optional[jnp.ndarray] = None,
    ov_dst: Optional[jnp.ndarray] = None,
):
    """Objective value from precomputed matrices and the neighbor table.

    fidelity = 0.5*(||Y||^2 - 2 Tr(Y^T beta X) + Tr(beta^T beta XtX))
    spatial  = 0.5*lambda*(sum_i deg_i ||beta_i||^2 - sum_i <beta_i, nbr_sum_i>)
    sparsity = rho*||beta||_1

    The spatial term expands Tr(beta^T (D - A) beta) without materializing L.
    """
    cross = jnp.sum(beta * Xty)
    BtB = jnp.dot(beta.T, beta, precision=_PREC)
    quad = jnp.sum(BtB * XtX)
    fidelity = 0.5 * (YtY - 2.0 * cross + quad)

    zero_row = jnp.zeros((1, beta.shape[1]), dtype=beta.dtype)
    beta_ext = jnp.concatenate([beta, zero_row], axis=0)
    ns = neighbor_sum(beta_ext, nbr_idx)
    if ov_src is not None:
        ns = ns + overflow_sum(beta_ext, ov_src, ov_dst, beta.shape[0])
    deg_term = jnp.sum(n_nbrs * jnp.sum(beta * beta, axis=1))
    adj_term = jnp.sum(beta * ns)
    spatial = 0.5 * lambda_ * (deg_term - adj_term)

    sparsity = rho * jnp.sum(jnp.abs(beta))
    return fidelity + spatial + sparsity


def bcd_sweep_banded(
    beta_in, Xty, XtX, offsets, masks, rest_nbr_idx, n_nbrs, lambda_, rho,
    halo: int,
):
    """BCD sweep with the banded neighbor decomposition (grid fast path)."""
    nbr_sum = neighbor_sum_banded(beta_in, offsets, masks, rest_nbr_idx, halo)
    beta_out = coordinate_descent(
        beta_in, Xty, XtX, nbr_sum, n_nbrs, lambda_, rho
    )
    return (beta_out, *sweep_stats(beta_out, beta_in))


@partial(jax.jit, static_argnames=("offsets", "max_iter", "halo"))
def bcd_iterate_banded(
    beta0, Xty, XtX, offsets, masks, rest_nbr_idx, n_nbrs, lambda_, rho, tol,
    max_iter: int, halo: int, iter_cap=None,
):
    """Fused solve loop over :func:`bcd_sweep_banded`; same convergence
    semantics as :func:`bcd_iterate`."""
    return converge_loop(
        lambda beta: bcd_sweep_banded(
            beta, Xty, XtX, offsets, masks, rest_nbr_idx, n_nbrs,
            lambda_, rho, halo=halo,
        ),
        beta0, tol, max_iter, iter_cap=iter_cap,
    )


@partial(jax.jit, static_argnames=("offsets", "halo"))
def objective_terms_banded(
    beta, Xty, XtX, YtY, offsets, masks, rest_nbr_idx, n_nbrs, lambda_, rho,
    halo: int,
):
    """Objective using the banded neighbor decomposition (no gather table).

    Same algebra as :func:`objective_terms`; lets the banded solve path skip
    building and transferring the (N, max_deg) padded gather table entirely.
    """
    cross = jnp.sum(beta * Xty)
    BtB = jnp.dot(beta.T, beta, precision=_PREC)
    quad = jnp.sum(BtB * XtX)
    fidelity = 0.5 * (YtY - 2.0 * cross + quad)

    ns = neighbor_sum_banded(beta, offsets, masks, rest_nbr_idx, halo)
    deg_term = jnp.sum(n_nbrs * jnp.sum(beta * beta, axis=1))
    adj_term = jnp.sum(beta * ns)
    spatial = 0.5 * lambda_ * (deg_term - adj_term)

    sparsity = rho * jnp.sum(jnp.abs(beta))
    return fidelity + spatial + sparsity


# Module-level jitted entry point: created once so the trace cache persists
# across bcd_solve calls (a fresh jax.jit wrapper per call would retrace and
# recompile every solve).
objective_terms_jit = jax.jit(objective_terms)
