"""Multi-host execution helpers (several hosts joined by a network).

The reference is strictly single-process (SURVEY.md §2.3); this module is the
thin layer that takes the spot-sharded solve from one host's devices to a
multi-host cluster:

* :func:`initialize` — ``jax.distributed.initialize`` wrapper (idempotent).
* :func:`global_spot_mesh` — 1-D ``"spots"`` mesh over every device in the
  job, ordered host-major so that contiguous Morton blocks land on the same
  host's devices first (halo edges then stay on the intra-host links and
  only shard boundaries cross the network between hosts).
* :func:`host_spot_range` — which contiguous spot rows this process owns
  under a :class:`~flashdeconv_tpu.parallel.partition.ShardPlan`, so each
  host can load only its slice of Y from disk.

Usage on an N-host slice (same script on every host)::

    from flashdeconv_tpu.parallel import multihost, sharded_bcd_solve
    multihost.initialize(coordinator, n_hosts, host_id)
    mesh = multihost.global_spot_mesh()
    beta, info = sharded_bcd_solve(Y_sketch, X_sketch, A, coords=coords,
                                   mesh=mesh)

``sharded_bcd_solve`` builds its device operands with
``jax.make_array_from_callback``, so each process materializes only the
shards it owns; passing the full ``Y_sketch`` on every host is supported
(simplest), and passing per-host slices is the scalable path (see
``host_spot_range``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
from jax.sharding import Mesh

_AXIS = "spots"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize JAX's distributed runtime (idempotent).

    Pass all three arguments explicitly unless a cluster environment that
    JAX auto-detects provides them. Must run before any JAX computation
    (anything that instantiates an XLA backend — including ``jax.devices()``
    — makes distributed initialization impossible): call this at program
    start.

    Intentionally does NOT touch ``jax.process_count()``/``jax.devices()``
    first — those would themselves initialize the backend and turn this call
    into a guaranteed failure.
    """
    if jax.distributed.is_initialized():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        msg = str(e).lower()
        if "already initialized" in msg:
            return
        if "must be called before" in msg:
            if coordinator_address is None and num_processes in (None, 1):
                # Single-process convenience call after JAX is already in
                # use: nothing to set up. (On a cluster this would be a late
                # call — warn so the silent-no-op trap is visible.)
                import warnings

                warnings.warn(
                    "multihost.initialize() called after the XLA backend "
                    "was created; distributed runtime not started. On a "
                    "multi-host cluster, call initialize() before any other "
                    "JAX use.",
                    RuntimeWarning,
                    stacklevel=2,
                )
                return
            raise RuntimeError(
                "jax.distributed must be initialized before any JAX "
                "computation; call flashdeconv_tpu.parallel.multihost."
                "initialize() at program start, before jax.devices() or "
                "any jit/device_put."
            ) from e
        raise


def global_spot_mesh() -> Mesh:
    """1-D mesh over all devices in the job, host-major order.

    ``jax.devices()`` already enumerates devices grouped by process; keeping
    that order means a contiguous block of shards maps to one host, so the
    Morton-contiguous partition puts most halo edges on intra-host links.
    """
    return Mesh(np.asarray(jax.devices()), (_AXIS,))


def allreduce_sums(*arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Element-wise sum of small host arrays across all processes.

    Single-process: identity. Multi-process: one fused
    ``process_allgather`` over the concatenation (the arrays are O(n_genes)
    — a few hundred KB — so one DCN round trip covers the whole reduction).
    """
    if jax.process_count() == 1:
        return arrays
    from jax.experimental import multihost_utils

    flat = np.concatenate([np.asarray(a, np.float64).ravel() for a in arrays])
    summed = np.asarray(
        multihost_utils.process_allgather(flat)
    ).sum(axis=0)
    out = []
    offset = 0
    for a in arrays:
        n = np.asarray(a).size
        out.append(summed[offset : offset + n].reshape(np.shape(a)))
        offset += n
    return tuple(out)


def allgather_rows(arr: np.ndarray) -> np.ndarray:
    """Concatenate per-process row blocks into the global array (row axis 0).

    Every process passes its own (possibly empty) block of rows in global
    order — process 0's rows first, then process 1's, etc. — and every
    process returns the identical concatenated array. Row counts may differ
    across processes (``jax.experimental.multihost_utils.process_allgather``
    alone requires equal shapes; this pads to the max count and slices).
    Trailing dimensions and dtype must match across processes.

    Single-process: returns ``arr`` unchanged (no copy).
    """
    if jax.process_count() == 1:
        return np.asarray(arr)
    from jax.experimental import multihost_utils

    arr = np.ascontiguousarray(arr)
    counts = np.asarray(
        multihost_utils.process_allgather(
            np.asarray([arr.shape[0]], dtype=np.int64)
        )
    ).ravel()
    max_rows = int(counts.max())
    if max_rows == 0:
        return arr
    padded = np.zeros((max_rows,) + arr.shape[1:], dtype=arr.dtype)
    padded[: arr.shape[0]] = arr
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    return np.concatenate(
        [gathered[p, : counts[p]] for p in range(gathered.shape[0])], axis=0
    )


def process_row_offsets(n_local: int) -> Tuple[int, int, int]:
    """(row_start, row_stop, n_global) of this process's contiguous slice.

    The one-call distributed fit's data contract: process p holds global
    rows ``[start_p, stop_p)`` where the starts are the exclusive prefix
    sums of the per-process row counts, in process order.
    """
    if jax.process_count() == 1:
        return 0, n_local, n_local
    from jax.experimental import multihost_utils

    counts = np.asarray(
        multihost_utils.process_allgather(
            np.asarray([n_local], dtype=np.int64)
        )
    ).ravel()
    p = jax.process_index()
    start = int(counts[:p].sum())
    return start, start + n_local, int(counts.sum())


def distributed_knn_graph(
    coords_local: np.ndarray,
    k: int = 6,
    include_self: bool = False,
    coords_global: Optional[np.ndarray] = None,
):
    """Global symmetrized kNN adjacency from per-process coordinate slices.

    Exact multi-host counterpart of
    :func:`flashdeconv_tpu.utils.graph.build_knn_graph` on the concatenated
    coordinates: the (tiny, 16 B/spot) coordinates are all-gathered once and
    every process builds the same KD-tree, but each process runs the
    **queries** — the O(N log N) bulk of the build — only for its own rows,
    then the directed edge lists are exchanged (one all-gather) and
    symmetrized identically everywhere. Per-query results are independent
    of which process issues them, so the result is bit-identical to the
    single-host build on the gathered coordinates.

    Returns ``(A, coords_global)`` with ``A`` the global scipy CSR
    adjacency, identical on every process.
    """
    from scipy import sparse
    from scipy.spatial import cKDTree

    if coords_global is None:
        coords_global = allgather_rows(np.asarray(coords_local, np.float64))
    n = coords_global.shape[0]
    row_start, _, _ = process_row_offsets(np.asarray(coords_local).shape[0])

    k_eff = min(k, n - 1)
    if k_eff <= 0:
        if include_self and n > 0:
            return (
                sparse.eye(n, dtype=np.float64, format="csr"), coords_global
            )
        return sparse.csr_matrix((n, n), dtype=np.float64), coords_global

    tree = cKDTree(coords_global)
    coords_local = np.asarray(coords_local, dtype=coords_global.dtype)
    if coords_local.shape[0] > 0:
        _, nbrs = tree.query(coords_local, k=k_eff + 1, workers=-1)
        rows = np.repeat(
            np.arange(row_start, row_start + coords_local.shape[0]),
            k_eff + 1,
        )
        cols = np.asarray(nbrs).ravel()
        if not include_self:
            keep = rows != cols
            rows, cols = rows[keep], cols[keep]
        edges_local = np.column_stack([rows, cols]).astype(np.int64)
    else:
        edges_local = np.zeros((0, 2), dtype=np.int64)

    edges = allgather_rows(edges_local)
    A = sparse.csr_matrix(
        (np.ones(edges.shape[0], dtype=np.float64),
         (edges[:, 0], edges[:, 1])),
        shape=(n, n),
    )
    A = A + A.T
    A.data[:] = 1.0
    return A, coords_global


def distributed_adjacency(
    coords_local: np.ndarray,
    method: str = "knn",
    k: int = 6,
    radius: Optional[float] = None,
    coords_global: Optional[np.ndarray] = None,
):
    """Global spatial adjacency from per-process coordinate slices.

    ``"knn"`` distributes the query workload (:func:`distributed_knn_graph`);
    ``"radius"`` / ``"grid"`` build from the gathered coordinates identically
    on every process (``cKDTree.query_pairs`` is inherently all-pairs; the
    coordinates are 16 B/spot, so the gathered build is cheap and exactly
    matches the single-host graph). Returns ``(A, coords_global)``.
    """
    from flashdeconv_tpu.utils.graph import (
        build_grid_graph,
        build_radius_graph,
    )

    if method == "knn":
        return distributed_knn_graph(
            coords_local, k=k, coords_global=coords_global
        )
    if coords_global is None:
        coords_global = allgather_rows(np.asarray(coords_local, np.float64))
    if method == "radius":
        if radius is None:
            raise ValueError("radius must be specified for radius method")
        return build_radius_graph(coords_global, radius=radius), coords_global
    if method == "grid":
        return build_grid_graph(coords_global), coords_global
    raise ValueError(f"Unknown method: {method}")


def distributed_subset_col_mean(
    Y_local, gene_idx: np.ndarray
) -> np.ndarray:
    """Global column means of ``Y[:, gene_idx]`` over spot-sharded rows.

    One ``allreduce_sums`` over the per-process column sums + row counts
    (the pearson preprocess needs the global gene means; float64 summation
    order differs from the single-host pass by at most last-ulp rounding).
    """
    from scipy import sparse

    from flashdeconv_tpu import native

    n_local = int(Y_local.shape[0])
    mu_local = (
        native.subset_col_mean(Y_local, gene_idx) if n_local > 0 else None
    )
    if mu_local is not None:
        col_sum = mu_local * float(n_local)
    else:
        sub = Y_local[:, gene_idx]
        if sparse.issparse(sub):
            col_sum = np.asarray(sub.sum(axis=0), dtype=np.float64).ravel()
        else:
            col_sum = np.asarray(sub, dtype=np.float64).sum(axis=0)
    col_sum, n_total = allreduce_sums(
        col_sum, np.asarray([float(n_local)])
    )
    return col_sum / max(float(n_total[0]), 1.0)


def distributed_gene_moments(Y_local) -> Tuple[np.ndarray, np.ndarray]:
    """HVG moments over a spot-sharded sparse count matrix.

    Each host computes the additive log1p-CPM column sums for its own spot
    slice (O(local nnz), using the native kernel when available) and the
    sums are all-reduced — the full matrix never exists on any single host.
    The per-spot CPM scaling only needs each row's own library size, so the
    host-local pass is exact. Returns the same (means, variances) the
    single-host path produces for the concatenated matrix.
    """
    from scipy import sparse

    from flashdeconv_tpu.utils.genes import log1p_cpm_sums, moments_from_sums

    if sparse.issparse(Y_local):
        col_sum, col_sumsq = log1p_cpm_sums(Y_local)
    else:
        # Dense slice: same log1p-CPM transform as the single-host dense
        # moments path (utils/genes._log1p_cpm_moments); the all-reduced
        # sum-of-squares variance agrees with its two-pass np.var to f64
        # rounding (not bitwise).
        Yd = np.asarray(Y_local, dtype=np.float64)
        lib = np.maximum(Yd.sum(axis=1, keepdims=True), 1.0)
        Ylog = np.log1p(Yd / lib * 1e4)
        col_sum = Ylog.sum(axis=0)
        col_sumsq = np.einsum("ij,ij->j", Ylog, Ylog)
    n_local = np.asarray([float(Y_local.shape[0])])
    col_sum, col_sumsq, n_total = allreduce_sums(col_sum, col_sumsq, n_local)
    return moments_from_sums(col_sum, col_sumsq, int(n_total[0]))


def distributed_select_informative_genes(
    Y_local,
    X: np.ndarray,
    n_hvg: int = 2000,
    n_markers_per_type: int = 50,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-host :func:`~flashdeconv_tpu.utils.genes.select_informative_genes`.

    ``Y_local`` is this host's spot slice (see :func:`host_spot_range`); the
    reference ``X`` is replicated, so marker selection and leverage scores
    are computed identically on every host, and the HVG moments are the one
    cross-host reduction. Every host returns the same gene set.
    """
    from flashdeconv_tpu.utils.genes import (
        compute_leverage_scores,
        hvg_from_moments,
        select_markers,
    )

    means, variances = distributed_gene_moments(Y_local)
    hvg_idx = hvg_from_moments(means, variances, n_top=n_hvg)
    marker_idx, _ = select_markers(X, n_markers=n_markers_per_type)
    gene_idx = np.union1d(hvg_idx, marker_idx).astype(np.intp)
    if gene_idx.size == 0:
        raise ValueError(
            "No genes selected. Increase n_hvg or n_markers_per_type."
        )
    return gene_idx, compute_leverage_scores(X[:, gene_idx])


def host_spot_range(
    plan, mesh: Optional[Mesh] = None
) -> Tuple[int, int]:
    """[start, stop) of ordered-spot rows owned by this process.

    Parameters
    ----------
    plan : :class:`~flashdeconv_tpu.parallel.partition.ShardPlan`
        The plan the solve will run with (``plan.n_shards`` must equal
        ``mesh.devices.size``). Using the plan — not a recomputed
        ``ceil(n/S)`` — matters because the solver may pad ``shard_size``
        (``plan_shards(pad_shard_to=...)``).

    Ordered-spot space is the plan's permuted, padded layout; use
    ``plan.perm`` to map back to the caller's original spot indices.
    """
    if mesh is None:
        mesh = global_spot_mesh()
    if plan.n_shards != mesh.devices.size:
        raise ValueError(
            f"plan has {plan.n_shards} shards but mesh has "
            f"{mesh.devices.size} devices"
        )
    shard_size = plan.shard_size
    local = [
        i for i, d in enumerate(mesh.devices.ravel())
        if d.process_index == jax.process_index()
    ]
    if not local:
        return 0, 0
    if local != list(range(local[0], local[-1] + 1)):
        # An interleaved mesh (round-robin devices across hosts) would
        # make [first, last+1) span other hosts' shards — every process
        # would then feed the wrong Y rows with no error anywhere
        # downstream. Host-major ordering is what global_spot_mesh()
        # builds and what keeps host boundaries on DCN (module
        # docstring); anything else is a wiring bug the caller must fix.
        raise ValueError(
            "this process's mesh devices are not contiguous in "
            f"mesh.devices.ravel() (local shard indices {local}); "
            "host_spot_range requires a host-major mesh — build it with "
            "global_spot_mesh()"
        )
    return local[0] * shard_size, (local[-1] + 1) * shard_size
