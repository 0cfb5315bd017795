"""REAL multi-process distributed execution (jax.distributed over Gloo).

Everything else in the suite exercises the mesh paths inside one process
(8 virtual devices). These tests launch 2 or 4 actual Python processes
that form a distributed JAX job over localhost (``multihost.initialize``
→ Gloo CPU collectives), splitting the same 8 global devices, and run
``sharded_bcd_solve`` through both strategies — exercising the
``jax.process_count() > 1`` branches (per-process shard materialization in
``make_array_from_callback``, the ``process_allgather`` beta collection)
that single-process tests cannot reach. The result must be BIT-IDENTICAL
to the same solve on a single-process 8-device mesh: the mesh topology is
the same, only the process boundaries moved.

The 4-process topology is the qualitatively new case: processes 1 and 2
are INTERIOR — each exchanges per-sweep ppermute halo blocks with a live
left AND right neighbor across two different process boundaries
simultaneously (a 2-process job only ever has one boundary, with one
sender per direction).

A multi-host cluster runs the same code path, with the coordinator, process
count and process id passed to ``multihost.initialize()`` — see
parallel/multihost.py.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from flashdeconv_tpu.utils.graph import build_knn_graph

REPO = Path(__file__).resolve().parent.parent

WORKER = """
import os, sys, json
sys.path.insert(0, {repo!r})
import numpy as np
pid, nproc, port, outdir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from flashdeconv_tpu.parallel import multihost
multihost.initialize(
    coordinator_address="localhost:" + port,
    num_processes=nproc,
    process_id=pid,
)
assert jax.process_count() == nproc

from flashdeconv_tpu.parallel import sharded_bcd_solve
from flashdeconv_tpu.utils.graph import build_knn_graph

rng = np.random.RandomState(0)
side = 16
xs, ys = np.meshgrid(np.arange(side), np.arange(side))
coords = np.column_stack([xs.ravel(), ys.ravel()]).astype(float)
n = coords.shape[0]
X_sketch = rng.randn(5, 32)
Y_sketch = np.abs(rng.randn(n, 5)) @ X_sketch + 0.05 * rng.randn(n, 32)
A = build_knn_graph(coords, k=4)

mesh = multihost.global_spot_mesh()
assert mesh.devices.size == 8

record = {{"processes": jax.process_count()}}
for strategy in ("banded", "halo"):
    beta, info = sharded_bcd_solve(
        Y_sketch, X_sketch, A, coords=coords, mesh=mesh, strategy=strategy,
        lambda_=0.3, max_iter=40, tol=1e-5, dtype=np.float64,
    )
    record[strategy] = {{
        "n_shards": info["n_shards"],
        "n_iterations": info["n_iterations"],
        "final_objective": info["final_objective"],
    }}
    np.save(os.path.join(outdir, f"beta_{{strategy}}_p{{pid}}.npy"), beta)

# Float32 GSPMD banded solve across the REAL process boundaries: the
# compiler-inserted halo transfers at every cross-process shard boundary
# ride Gloo here (the interconnect between hosts on a cluster) — with 4
# processes the interior ones send AND receive across two boundaries per
# sweep. Must be bit-identical to the single-process 8-device solve.
from flashdeconv_tpu.parallel.gspmd import GspmdBandedProblem

pf32 = GspmdBandedProblem(
    Y_sketch, X_sketch, A, mesh=mesh, dtype=np.float32,
)
beta_f, info_f = pf32.solve(lambda_=0.3, max_iter=40, tol=1e-5)
record["banded_f32"] = {{
    "n_iterations": info_f["n_iterations"],
    "final_objective": info_f["final_objective"],
}}
np.save(os.path.join(outdir, f"beta_banded_f32_p{{pid}}.npy"), beta_f)

# Distributed gene selection: each process holds ONLY its slice of the
# spots; the HVG moments are the one cross-process reduction
# (allreduce_sums -> process_allgather). Must reproduce the single-host
# gene set exactly.
from scipy import sparse
from flashdeconv_tpu.parallel.multihost import (
    distributed_select_informative_genes,
)

grng = np.random.RandomState(7)
G, K2 = 500, 6
Xref = grng.gamma(2.0, 1.0, size=(K2, G)) * (grng.rand(K2, G) < 0.3)
counts = sparse.random(
    n, G, density=0.1, format="csr", random_state=3,
    data_rvs=lambda k: grng.poisson(5, k).astype(np.float64) + 1.0,
)
rows = n // nproc
Y_local = counts[pid * rows:(pid + 1) * rows]
gene_idx, leverage = distributed_select_informative_genes(
    Y_local, Xref, n_hvg=100, n_markers_per_type=10
)
np.save(os.path.join(outdir, f"gene_idx_p{{pid}}.npy"), gene_idx)
np.save(os.path.join(outdir, f"leverage_p{{pid}}.npy"), leverage)

with open(os.path.join(outdir, f"record_p{{pid}}.json"), "w") as f:
    json.dump(record, f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# One-call multi-host pipeline: each process holds ONLY its contiguous
# slice of (Y, coords) through the FULL fit — distributed gene selection,
# per-host fused Xty feed, distributed kNN graph build (local queries +
# edge exchange), global lambda auto-tune, sharded solve. Rows are split
# UNEVENLY to exercise the variable-count allgather. Two spatial configs
# cover both sharded strategies (row-major grid -> GSPMD banded;
# irregular kNN -> halo plan).
PIPELINE_WORKER = """
import os, sys, json
sys.path.insert(0, {repo!r})
import numpy as np
pid, nproc, port, outdir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from flashdeconv_tpu.parallel import multihost
multihost.initialize(
    coordinator_address="localhost:" + port,
    num_processes=nproc,
    process_id=pid,
)
assert jax.process_count() == nproc

from scipy import sparse
from flashdeconv_tpu import FlashDeconv

rng = np.random.RandomState(0)
side = 16
xs, ys = np.meshgrid(np.arange(side), np.arange(side))
coords = np.column_stack([xs.ravel(), ys.ravel()]).astype(float)
n = coords.shape[0]
G, K = 400, 6
X = rng.gamma(2.0, 1.0, size=(K, G)) * (rng.rand(K, G) < 0.3)
bt = rng.dirichlet(np.ones(K), size=n)
Y = sparse.csr_matrix(rng.poisson(bt @ X * 25.0).astype(np.float64))
coords_irr = np.random.RandomState(5).rand(n, 2) * side

cuts = np.round(np.linspace(0, n, nproc + 1)).astype(int)
cuts[1:-1] -= 17  # uneven slices: variable-row allgather paths
lo, hi = int(cuts[pid]), int(cuts[pid + 1])

mesh = multihost.global_spot_mesh()
assert mesh.devices.size == 8

record = {{"processes": nproc, "rows": [lo, hi]}}
for name, cc in (("grid", coords), ("irr", coords_irr)):
    model = FlashDeconv(
        sketch_dim=64, n_hvg=120, n_markers_per_type=10, max_iter=40,
        tol=1e-5, solver_dtype=np.float64, random_state=0, mesh=mesh,
    )
    model.fit_distributed(Y[lo:hi], X, cc[lo:hi])
    assert model.host_rows_ == (lo, hi)
    np.save(os.path.join(outdir, f"pipe_beta_{{name}}_p{{pid}}.npy"),
            model.beta_)
    np.save(os.path.join(outdir, f"pipe_props_{{name}}_p{{pid}}.npy"),
            model.proportions_)
    np.save(os.path.join(outdir, f"pipe_genes_{{name}}_p{{pid}}.npy"),
            model.gene_idx_)
    record[name] = {{
        "lambda": model.lambda_used_,
        "n_iterations": model.info_["n_iterations"],
        "final_objective": model.info_["final_objective"],
        "n_shards": model.info_["n_shards"],
        "converged": bool(model.info_["converged"]),
        "avg_degree": float(model.adjacency_.nnz) / n,
    }}

with open(os.path.join(outdir, f"pipe_record_p{{pid}}.json"), "w") as f:
    json.dump(record, f)
"""


VARIANTS_WORKER = """
import os, sys, json
sys.path.insert(0, {repo!r})
import numpy as np
pid, nproc, port, outdir = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
)
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from flashdeconv_tpu.parallel import multihost
multihost.initialize(
    coordinator_address="localhost:" + port,
    num_processes=nproc,
    process_id=pid,
)
assert jax.process_count() == nproc

from scipy import sparse
from flashdeconv_tpu import FlashDeconv

rng = np.random.RandomState(0)
side = 16
xs, ys = np.meshgrid(np.arange(side), np.arange(side))
coords = np.column_stack([xs.ravel(), ys.ravel()]).astype(float)
n = coords.shape[0]
G, K = 400, 6
X = rng.gamma(2.0, 1.0, size=(K, G)) * (rng.rand(K, G) < 0.3)
bt = rng.dirichlet(np.ones(K), size=n)
Y = sparse.csr_matrix(rng.poisson(bt @ X * 25.0).astype(np.float64))

cuts = np.round(np.linspace(0, n, nproc + 1)).astype(int)
cuts[1:-1] -= 17
lo, hi = int(cuts[pid]), int(cuts[pid + 1])

mesh = multihost.global_spot_mesh()
assert mesh.devices.size == 8

CASES = {{
    "pearson": dict(preprocess="pearson"),
    "radius": dict(spatial_method="radius", radius=1.5),
    "gridm": dict(spatial_method="grid"),
}}
record = {{"processes": nproc, "rows": [lo, hi]}}
for name, kw in CASES.items():
    model = FlashDeconv(
        sketch_dim=64, n_hvg=120, n_markers_per_type=10, max_iter=40,
        tol=1e-5, solver_dtype=np.float64, random_state=0, mesh=mesh,
        **kw,
    )
    model.fit_distributed(Y[lo:hi], X, coords[lo:hi])
    np.save(os.path.join(outdir, f"var_beta_{{name}}_p{{pid}}.npy"),
            model.beta_)
    np.save(os.path.join(outdir, f"var_genes_{{name}}_p{{pid}}.npy"),
            model.gene_idx_)
    record[name] = {{
        "lambda": model.lambda_used_,
        "n_iterations": model.info_["n_iterations"],
        "final_objective": model.info_["final_objective"],
        "avg_degree": float(model.adjacency_.nnz) / n,
        "converged": bool(model.info_["converged"]),
    }}

with open(os.path.join(outdir, f"var_record_p{{pid}}.json"), "w") as f:
    json.dump(record, f)
"""


def test_fit_distributed_noncanonical_paths(tmp_path):
    """2-process ``fit_distributed`` for the NON-canonical configurations
    (round-5 verdict item 7): pearson preprocessing (global gene means are
    one cross-host allreduce -> float64-rounding agreement, per the
    documented contract) and radius/grid spatial adjacency (built from the
    gathered coordinates -> bit-identical to single-process)."""
    nproc = 2
    worker = tmp_path / "var_worker.py"
    worker.write_text(VARIANTS_WORKER.format(repo=str(REPO)))
    port = str(_free_port())

    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={8 // nproc}"
    )
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_ENABLE_X64", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(nproc), port,
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(nproc)
    ]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"

    records = [
        json.loads((tmp_path / f"var_record_p{pid}.json").read_text())
        for pid in range(nproc)
    ]

    # Single-process references over the same 8-device virtual mesh.
    from scipy import sparse

    from flashdeconv_tpu import FlashDeconv

    rng = np.random.RandomState(0)
    side = 16
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    coords = np.column_stack([xs.ravel(), ys.ravel()]).astype(float)
    n = coords.shape[0]
    G, K = 400, 6
    X = rng.gamma(2.0, 1.0, size=(K, G)) * (rng.rand(K, G) < 0.3)
    bt = rng.dirichlet(np.ones(K), size=n)
    Y = sparse.csr_matrix(rng.poisson(bt @ X * 25.0).astype(np.float64))

    cases = {
        "pearson": dict(preprocess="pearson"),
        "radius": dict(spatial_method="radius", radius=1.5),
        "gridm": dict(spatial_method="grid"),
    }
    for name, kw in cases.items():
        ref = FlashDeconv(
            sketch_dim=64, n_hvg=120, n_markers_per_type=10, max_iter=40,
            tol=1e-5, solver_dtype=np.float64, random_state=0, n_shards=8,
            **kw,
        ).fit(Y, X, coords)
        for pid in range(nproc):
            beta = np.load(tmp_path / f"var_beta_{name}_p{pid}.npy")
            genes = np.load(tmp_path / f"var_genes_{name}_p{pid}.npy")
            rec = records[pid][name]
            # gene selection is log-CPM-moment-based in every mode: exact.
            np.testing.assert_array_equal(genes, ref.gene_idx_)
            assert rec["n_iterations"] == ref.info_["n_iterations"]
            assert rec["converged"] == ref.info_["converged"]
            assert rec["avg_degree"] == pytest.approx(
                float(ref.adjacency_.nnz) / n
            )
            if name == "pearson":
                # documented bound: cross-host sums reassociate -> f64
                # rounding agreement, not bit equality
                np.testing.assert_allclose(
                    beta, ref.beta_, rtol=1e-9, atol=1e-12
                )
                assert rec["final_objective"] == pytest.approx(
                    ref.info_["final_objective"], rel=1e-10
                )
            else:
                # canonical log_cpm feed + coordinate-gathered adjacency:
                # bit-identical
                np.testing.assert_array_equal(beta, ref.beta_)
                assert rec["final_objective"] == pytest.approx(
                    ref.info_["final_objective"], rel=1e-12
                )
            assert rec["lambda"] == pytest.approx(
                ref.lambda_used_, rel=1e-12
            )


def test_fit_distributed_two_process_matches_single_fit(tmp_path):
    """FULL one-call pipeline across a REAL process boundary, bit-identical
    to single-process ``fit`` on the concatenated inputs (VERDICT r3 #4)."""
    nproc = 2
    worker = tmp_path / "pipe_worker.py"
    worker.write_text(PIPELINE_WORKER.format(repo=str(REPO)))
    port = str(_free_port())

    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={8 // nproc}"
    )
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_ENABLE_X64", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(nproc), port,
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(nproc)
    ]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"

    records = [
        json.loads((tmp_path / f"pipe_record_p{pid}.json").read_text())
        for pid in range(nproc)
    ]
    # Contiguous uneven cover of all rows, in process order.
    assert records[0]["rows"][0] == 0 and records[-1]["rows"][1] == 256
    assert records[0]["rows"][1] == records[1]["rows"][0] != 128

    # Single-process reference: plain fit() on the concatenated inputs
    # over the same 8-device (virtual) mesh.
    from scipy import sparse

    from flashdeconv_tpu import FlashDeconv

    rng = np.random.RandomState(0)
    side = 16
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    coords = np.column_stack([xs.ravel(), ys.ravel()]).astype(float)
    n = coords.shape[0]
    G, K = 400, 6
    X = rng.gamma(2.0, 1.0, size=(K, G)) * (rng.rand(K, G) < 0.3)
    bt = rng.dirichlet(np.ones(K), size=n)
    Y = sparse.csr_matrix(rng.poisson(bt @ X * 25.0).astype(np.float64))
    coords_irr = np.random.RandomState(5).rand(n, 2) * side

    for name, cc in (("grid", coords), ("irr", coords_irr)):
        ref = FlashDeconv(
            sketch_dim=64, n_hvg=120, n_markers_per_type=10, max_iter=40,
            tol=1e-5, solver_dtype=np.float64, random_state=0, n_shards=8,
        ).fit(Y, X, cc)
        for pid in range(nproc):
            beta = np.load(tmp_path / f"pipe_beta_{name}_p{pid}.npy")
            props = np.load(tmp_path / f"pipe_props_{name}_p{pid}.npy")
            genes = np.load(tmp_path / f"pipe_genes_{name}_p{pid}.npy")
            np.testing.assert_array_equal(genes, ref.gene_idx_)
            np.testing.assert_array_equal(beta, ref.beta_)
            np.testing.assert_array_equal(props, ref.proportions_)
            rec = records[pid][name]
            assert rec["lambda"] == ref.lambda_used_  # replicated closed form
            assert rec["n_iterations"] == ref.info_["n_iterations"]
            assert rec["n_shards"] == 8
            assert rec["converged"] == ref.info_["converged"]
            # YtY is a cross-host sum (reassociated): objective to 1e-12.
            assert rec["final_objective"] == pytest.approx(
                ref.info_["final_objective"], rel=1e-12
            )
            assert rec["avg_degree"] == pytest.approx(
                float(ref.adjacency_.nnz) / n
            )


@pytest.mark.parametrize(
    "nproc", [2, 4], ids=["2proc-boundary", "4proc-interior"]
)
def test_multi_process_solve_matches_single_process(tmp_path, nproc):
    devices_per_proc = 8 // nproc
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=str(REPO)))
    port = str(_free_port())

    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices_per_proc}"
    )
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_ENABLE_X64", None)  # the worker sets x64 via jax.config

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(nproc), port,
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(nproc)
    ]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        # If one worker hangs (e.g. its peer crashed inside the Gloo
        # barrier), kill ALL so no orphan holds the coordinator port.
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"

    records = [
        json.loads((tmp_path / f"record_p{pid}.json").read_text())
        for pid in range(nproc)
    ]
    assert all(r["processes"] == nproc for r in records)

    # in-process single-process reference on the same 8-device mesh
    from flashdeconv_tpu.parallel import sharded_bcd_solve

    rng = np.random.RandomState(0)
    side = 16
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    coords = np.column_stack([xs.ravel(), ys.ravel()]).astype(float)
    n = coords.shape[0]
    X_sketch = rng.randn(5, 32)
    Y_sketch = np.abs(rng.randn(n, 5)) @ X_sketch + 0.05 * rng.randn(n, 32)
    A = build_knn_graph(coords, k=4)

    for strategy in ("banded", "halo"):
        beta_ref, info_ref = sharded_bcd_solve(
            Y_sketch, X_sketch, A, coords=coords, n_shards=8,
            strategy=strategy, lambda_=0.3, max_iter=40, tol=1e-5,
            dtype=np.float64,
        )
        for pid in range(nproc):
            beta_mp = np.load(tmp_path / f"beta_{strategy}_p{pid}.npy")
            np.testing.assert_array_equal(beta_mp, beta_ref)
            rec = records[pid][strategy]
            assert rec["n_shards"] == 8
            assert rec["n_iterations"] == info_ref["n_iterations"]
            assert rec["final_objective"] == pytest.approx(
                info_ref["final_objective"], rel=1e-12
            )

    # Float32 GSPMD solve: single-process 8-device reference.
    import jax
    from jax.sharding import Mesh

    from flashdeconv_tpu.parallel.gspmd import GspmdBandedProblem

    mesh8 = Mesh(np.asarray(jax.devices()[:8]), ("spots",))
    pf32_ref = GspmdBandedProblem(
        Y_sketch, X_sketch, A, mesh=mesh8, dtype=np.float32,
    )
    beta_f32_ref, info_f32_ref = pf32_ref.solve(
        lambda_=0.3, max_iter=40, tol=1e-5
    )
    for pid in range(nproc):
        beta_mp = np.load(tmp_path / f"beta_banded_f32_p{pid}.npy")
        np.testing.assert_array_equal(beta_mp, beta_f32_ref)
        assert (records[pid]["banded_f32"]["n_iterations"]
                == info_f32_ref["n_iterations"])

    # Distributed gene selection across the real process boundary must
    # reproduce the single-host gene set on the concatenated matrix
    # (the HVG moments are additive; allreduce_sums is the one reduction).
    from scipy import sparse

    from flashdeconv_tpu.utils.genes import select_informative_genes

    grng = np.random.RandomState(7)
    G, K2 = 500, 6
    Xref = grng.gamma(2.0, 1.0, size=(K2, G)) * (grng.rand(K2, G) < 0.3)
    counts = sparse.random(
        n, G, density=0.1, format="csr", random_state=3,
        data_rvs=lambda k: grng.poisson(5, k).astype(np.float64) + 1.0,
    )
    rows = n // nproc
    idx_ref, lev_ref = select_informative_genes(
        counts[: nproc * rows], Xref, n_hvg=100, n_markers_per_type=10
    )
    for pid in range(nproc):
        idx_mp = np.load(tmp_path / f"gene_idx_p{pid}.npy")
        lev_mp = np.load(tmp_path / f"leverage_p{pid}.npy")
        np.testing.assert_array_equal(idx_mp, idx_ref)
        np.testing.assert_allclose(lev_mp, lev_ref, rtol=1e-12)
