"""Choice of sweep implementation, the GPU-only entry points' refusals on
a machine without a card, the compile-cache location, and the sharded paths
that replaced the old mesh kernel tier (virtual CPU devices)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from flashdeconv_tpu.core import solver as core_solver
from flashdeconv_tpu.ops.sweep_kernel import KERNEL_MAX_K
from flashdeconv_tpu.utils.graph import build_knn_graph, grid_coords

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform,dtype,n_types,overflow,expected",
    [
        ("gpu", np.float32, 20, False, True),
        ("gpu", np.float32, KERNEL_MAX_K, False, True),
        ("gpu", np.float32, KERNEL_MAX_K + 1, False, False),
        ("gpu", np.float64, 20, False, False),
        ("gpu", np.float32, 20, True, False),
        ("cpu", np.float32, 20, False, False),
    ],
)
def test_use_sweep_kernel(platform, dtype, n_types, overflow, expected):
    assert core_solver.use_sweep_kernel(
        platform, dtype, n_types, overflow=overflow
    ) is expected


def _problem(n_types, coords, seed=0):
    rng = np.random.RandomState(seed)
    A = build_knn_graph(coords, k=6)
    X = rng.randn(n_types, 32)
    Y = rng.rand(coords.shape[0], n_types) @ X + 0.1 * rng.randn(
        coords.shape[0], 32
    )
    return Y, X, A


@pytest.mark.parametrize(
    "graph,n_types,kernel",
    [("grid", 20, True), ("irregular", 20, True),
     ("grid", KERNEL_MAX_K + 1, False)],
)
def test_bcd_problem_picks_kernel_on_gpu(monkeypatch, graph, n_types,
                                         kernel):
    """With a GPU device under the operands, float32 grid and gather
    problems take the Pallas sweep; large K stays on XLA. Gating only —
    the constructor never runs a sweep."""
    monkeypatch.setattr(core_solver, "_device_platform", lambda arr: "gpu")
    coords = (grid_coords(side=96) if graph == "grid"
              else np.random.RandomState(1).rand(3000, 2) * 50)
    Y, X, A = _problem(n_types, coords)
    prob = core_solver.prepare_bcd(Y, X, A, coords=coords)
    assert prob.use_banded is (graph == "grid")
    assert prob.sweep_kernel == ("pallas_triton" if kernel else "xla")


def test_bcd_problem_on_cpu_runs_xla():
    coords = grid_coords(side=96)
    Y, X, A = _problem(6, coords)
    prob = core_solver.prepare_bcd(Y, X, A, coords=coords)
    assert prob.sweep_kernel == "xla"
    # the masks stay uint8 on device; no spot-axis padding
    assert prob.masks_d.dtype == jnp.uint8
    assert prob.Xty_d.shape[0] == coords.shape[0]
    _, info = prob.solve(max_iter=3)
    assert info["sweep_kernel"] == "xla"


def test_banded_objective_uint8_masks_equal_float_masks():
    from flashdeconv_tpu.ops.bcd import objective_terms_banded
    from flashdeconv_tpu.utils.graph import banded_split

    coords = grid_coords(side=40)
    A = build_knn_graph(coords, k=6)
    offsets, masks, _ = banded_split(A, max_offsets=32)
    rng = np.random.RandomState(0)
    n = coords.shape[0]
    beta = jnp.asarray(np.abs(rng.randn(n, 5)), jnp.float32)
    Xs = rng.randn(5, 16)
    args = (jnp.asarray(np.abs(rng.randn(n, 5)), jnp.float32),
            jnp.asarray(Xs @ Xs.T, jnp.float32), jnp.float32(1e3),
            tuple(int(o) for o in offsets))
    rest = jnp.zeros((n, 0), jnp.int32)
    nnb = jnp.asarray(np.diff(A.tocsr().indptr).astype(np.float32))
    halo = int(np.max(np.abs(offsets)))
    vals = [
        float(objective_terms_banded(
            beta, *args, jnp.asarray(masks.astype(dt)), rest, nnb,
            jnp.float32(0.5), jnp.float32(0.1), halo,
        ))
        for dt in (np.uint8, np.float32)
    ]
    assert vals[0] == vals[1]


class TestShardedXlaPaths:
    """GSPMD and halo meshes run XLA's sweep; on virtual CPU devices they
    must reproduce the single-device float32 solve."""

    def _data(self, side=64, seed=7):
        coords = grid_coords(side=side)
        Y, X, A = _problem(6, coords, seed=seed)
        return Y, X, A, coords

    @pytest.mark.parametrize("strategy", ["banded", "halo"])
    def test_matches_single_device(self, strategy):
        from flashdeconv_tpu.parallel.solver import prepare_sharded_bcd

        Y, X, A, coords = self._data()
        kw = dict(lambda_=0.3, rho=0.01, max_iter=20, tol=0.0)
        ref, _ = core_solver.prepare_bcd(Y, X, A).solve(**kw)
        sp = prepare_sharded_bcd(Y, X, A, coords=coords, n_shards=4,
                                 strategy=strategy)
        assert sp.strategy == strategy
        beta, info = sp.solve(**kw)
        assert info["n_iterations"] == 20
        np.testing.assert_allclose(beta, ref, atol=2e-5)

    def test_gspmd_shard_count_invariance(self):
        from jax.sharding import Mesh

        from flashdeconv_tpu.parallel.gspmd import GspmdBandedProblem

        Y, X, A, _ = self._data(seed=3)
        betas = []
        for s in (1, 8):
            mesh = Mesh(np.asarray(jax.devices()[:s]), ("spots",))
            p = GspmdBandedProblem(Y, X, A, mesh=mesh, dtype=np.float32)
            beta, info = p.solve(lambda_=0.2, rho=0.01, max_iter=30,
                                 tol=1e-5)
            assert info["sweep_kernel"] == "xla"
            betas.append(beta)
        np.testing.assert_allclose(betas[1], betas[0], atol=2e-5)


def _run(args, cwd=ROOT, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_bench_without_gpu_prints_error_and_fails():
    r = _run(["bench.py"])
    assert r.returncode != 0
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert "error" in last and last["platform"] == "cpu"


def test_chip_smoke_without_gpu_fails_without_result():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_chip_smoke_alone_fails_without_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_location(tmp_path, env_dir):
    """``JAX_COMPILATION_CACHE_DIR`` when set; else ``<repo>/.jax_cache``."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_dir else {}
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra)
    r = subprocess.run(
        [sys.executable, "-c",
         "import flashdeconv_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    want = str(tmp_path) if env_dir else os.path.join(ROOT, ".jax_cache")
    assert r.stdout.strip().splitlines()[-1] == want


def test_dryrun_multichip_refuses_too_few_devices():
    sys.path.insert(0, ROOT)
    try:
        import __graft_entry__ as entry
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(RuntimeError, match="devices"):
        entry.dryrun_multichip(len(jax.devices()) + 1)
