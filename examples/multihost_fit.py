"""One-call multi-host fit demo: each process holds only its spot slice.

Demonstrates ``FlashDeconv.fit_distributed`` — the pipeline the reference
cannot run at all (it is single-process by construction, reference
``flashdeconv/core/solver.py:104-184`` threads over shared memory): every
process of a ``jax.distributed`` job loads only its contiguous block of
global spot rows, and the full count matrix never exists on any host.

Two ways to use it:

1. **Locally, as a self-test** (what a bare invocation runs) —
   ``python examples/multihost_fit.py`` forks itself into a 2-process
   Gloo job over localhost with 4 virtual CPU devices per process
   (8 global), runs the distributed fit, and checks the result against a
   single-process ``fit`` on the full data.

2. **On a multi-host cluster** — adapt the body of :func:`worker` into
   your per-host script: call ``multihost.initialize()`` with the
   coordinator address, process count and this host's process id (the
   CPU-platform override below exists only for the localhost self-test),
   compute this host's row slice with ``process_row_offsets``, and call
   ``fit_distributed`` with the local rows. Everything from the slice
   computation down is identical on a cluster. See docs/deployment.md.

The result is bit-identical to single-process ``fit`` on the concatenated
inputs for the canonical CSR + log_cpm pipeline (see
``tests/test_multihost_exec.py`` for the enforced version of that claim).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from flashdeconv_tpu.utils.graph import grid_coords


def make_data(n_side: int = 32, n_genes: int = 500, n_types: int = 8):
    """Deterministic synthetic dataset — identical on every process."""
    import numpy as np
    from scipy import sparse

    rng = np.random.RandomState(0)
    coords = grid_coords(side=n_side)
    n = coords.shape[0]
    X = rng.gamma(2.0, 1.0, size=(n_types, n_genes))
    X *= rng.rand(n_types, n_genes) < 0.3
    beta_true = rng.dirichlet(np.ones(n_types), size=n)
    Y = sparse.csr_matrix(
        rng.poisson(beta_true @ X * 25.0).astype(np.float64)
    )
    return Y, X, coords


def worker(process_id: int, n_processes: int, port: str) -> None:
    """What every host runs: initialize -> slice -> fit_distributed."""
    import jax

    # Local self-test plumbing; on a real pod, initialize() takes no
    # arguments and everything below the slice computation is identical.
    jax.config.update("jax_platforms", "cpu")

    from flashdeconv_tpu.parallel import multihost

    multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=n_processes,
        process_id=process_id,
    )

    import numpy as np

    from flashdeconv_tpu import FlashDeconv

    Y, X, coords = make_data()
    n = Y.shape[0]

    # Each process keeps ONLY its contiguous block of global rows. On a
    # real pod this is where each host would load its own slice from disk
    # (process 0's rows first, then process 1's, ...).
    cuts = np.linspace(0, n, n_processes + 1).astype(int)
    lo, hi = cuts[process_id], cuts[process_id + 1]

    model = FlashDeconv(
        sketch_dim=128, n_hvg=150, n_markers_per_type=15,
        mesh=multihost.global_spot_mesh(), random_state=0,
    )
    model.fit_distributed(Y[lo:hi], X, coords[lo:hi])

    # Every process ends with the IDENTICAL fitted state for all N spots.
    print(
        f"[process {process_id}/{n_processes}] fitted rows [{lo}, {hi}) of "
        f"{n}; proportions {model.proportions_.shape}, "
        f"{model.info_['n_iterations']} sweeps over "
        f"{model.info_['n_shards']} shards, "
        f"converged={model.info_['converged']}"
    )

    if process_id == 0:
        np.save("/tmp/multihost_fit_demo_props.npy", model.proportions_)


def main() -> None:
    import socket
    import subprocess

    import numpy as np

    n_processes = 2
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"

    # Ephemeral-port discovery (bind-then-close) races with other
    # processes claiming the port before the Gloo coordinator binds it —
    # retry the whole job once on failure rather than hanging a user on
    # an intermittent flake.
    for attempt in (1, 2):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])

        procs = [
            subprocess.Popen(
                [sys.executable, __file__, str(pid), str(n_processes), port],
                env=env,
            )
            for pid in range(n_processes)
        ]
        try:
            for p in procs:
                p.wait(timeout=300)
        finally:
            # If one worker died inside the Gloo barrier, its peer would
            # hang; kill stragglers so the demo always terminates.
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if all(p.returncode == 0 for p in procs):
            break
        if attempt == 1:
            print("# worker failed (possible port race) — retrying once",
                  file=sys.stderr)
    assert all(p.returncode == 0 for p in procs), "worker failed"

    # Cross-check against a plain single-process fit on the full data.
    import jax

    jax.config.update("jax_platforms", "cpu")

    from flashdeconv_tpu import FlashDeconv

    Y, X, coords = make_data()
    ref = FlashDeconv(
        sketch_dim=128, n_hvg=150, n_markers_per_type=15, random_state=0,
    ).fit(Y, X, coords)
    props = np.load("/tmp/multihost_fit_demo_props.npy")
    diff = float(np.abs(props - ref.proportions_).max())
    print(f"max |distributed - single-process| proportions: {diff:.2e}")
    assert diff < 1e-6
    print("multi-host demo OK")


if __name__ == "__main__":
    if len(sys.argv) == 4:  # forked worker: pid nproc port
        worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    else:
        main()
