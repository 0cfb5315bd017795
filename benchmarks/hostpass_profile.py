"""Root-cause probe for the 10M-spot host-pass non-linearity.

A host-pass timing that grows faster than linear in nnz between 1M and
10M spots can come from the kernel or from the host. This script isolates
the kernel from the pipeline and the environment:

- the SAME synthetic CSR row pattern at 1M rows and tiled to 10M rows
  (identical per-row work, warm pages in both cases, measured in ONE
  process back to back), so any per-nnz rate difference is intrinsic to
  scale (cache/TLB/NUMA), not workload;
- identical int64 index width in BOTH runs (pinned via direct attribute
  assignment — the scipy constructor would silently downcast the small
  case to int32 while the 6B-nnz indptr forces the big case to int64,
  confounding the per-nnz comparison with a 4 B/nnz stream difference
  and paying a hidden 48 GiB upcast copy). Production at 10M spots runs
  the i64 kernels too (scipy canonicalizes by indptr contents); the 1M
  production case runs i32 and streams 4 B/nnz less — that difference
  is real but is NOT what this probe measures;
- a memory-bandwidth probe interleaved between runs, so environment
  drift is visible in the same log;
- both fused passes (Xty contraction and the gene-selection moments).

Run on the host (no accelerator involvement): ``python benchmarks/hostpass_profile.py``.
Budget ~75 GiB RAM (24 GiB f32 data + 48 GiB int64 indices at 6B nnz)
and several minutes for the 10M tiling.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

N_SMALL = int(os.environ.get("HOSTPASS_ROWS", 1_000_000))
TILE = int(os.environ.get("HOSTPASS_TILE", 10))
G = 20_000
NNZ_ROW = 600
G_SEL = 3_000
D, K = 512, 25
REPS = 3


def bw_probe(buf):
    t0 = time.perf_counter()
    s = float(np.sum(buf))
    dt = time.perf_counter() - t0
    return buf.nbytes / dt / 1e9, s


def run(tag, native, indptr, indices, data, gene_idx, buckets, weights,
        Xsk, results):
    from scipy import sparse

    n_rows = indptr.size - 1
    # Direct attribute assignment: the (data, indices, indptr)
    # constructor canonicalizes the index dtype by CONTENTS (int32 when
    # everything fits), which would give the two runs different index
    # widths — see the module docstring.
    Y = sparse.csr_matrix((n_rows, G), dtype=data.dtype)
    Y.data, Y.indices, Y.indptr = data, indices, indptr
    assert Y.indices.dtype == np.int64 and Y.indptr.dtype == np.int64
    times = []
    for rep in range(REPS):
        t0 = time.perf_counter()
        out = native.fused_log1pcpm_xty(
            Y, gene_idx, buckets, weights, D, Xsk
        )
        dt = time.perf_counter() - t0
        assert out is not None
        times.append(dt)
        rate = data.size / dt / 1e9
        print(f"# {tag} xty rep{rep}: {dt:6.2f} s  ({rate:.2f} Gnnz/s)",
              file=sys.stderr, flush=True)
    results[f"{tag}_xty_s"] = [round(t, 2) for t in times]
    results[f"{tag}_xty_ns_per_nnz"] = round(
        min(times) / data.size * 1e9, 3
    )

    times = []
    for rep in range(REPS):
        t0 = time.perf_counter()
        mom = native.log1p_cpm_moments_auto(Y)
        dt = time.perf_counter() - t0
        assert mom is not None
        times.append(dt)
        print(f"# {tag} moments rep{rep}: {dt:6.2f} s", file=sys.stderr,
              flush=True)
    results[f"{tag}_moments_s"] = [round(t, 2) for t in times]
    results[f"{tag}_moments_ns_per_nnz"] = round(
        min(times) / data.size * 1e9, 3
    )


def main():
    from flashdeconv_tpu import native
    from flashdeconv_tpu.utils.hostmem import reserve_host_arena

    t0 = time.perf_counter()
    reserve_host_arena(8)
    print(f"# arena 8 GB in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    rng = np.random.default_rng(0)
    # One sorted random index template shared by all rows: the gather
    # target new_col is L2-resident either way, and the scan/compress is
    # branchless, so regularity does not flatter the kernel.
    tmpl = np.sort(
        rng.choice(G, size=NNZ_ROW, replace=False).astype(np.int64)
    )
    gene_idx = np.sort(rng.choice(G, size=G_SEL, replace=False))
    buckets = rng.integers(0, D, size=G_SEL).astype(np.int32)
    weights = rng.random(G_SEL)
    Xsk = rng.standard_normal((K, D))

    print(f"# building {N_SMALL}-row CSR ({N_SMALL * NNZ_ROW / 1e6:.0f}M "
          "nnz)...", file=sys.stderr)
    t0 = time.perf_counter()
    indices_s = np.tile(tmpl, N_SMALL)
    data_s = rng.random(NNZ_ROW).astype(np.float32)  # per-row pattern
    data_s = np.tile(data_s * 50.0 + 1.0, N_SMALL)
    indptr_s = np.arange(N_SMALL + 1, dtype=np.int64) * NNZ_ROW
    print(f"# built in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    probe = np.ones(1 << 28, np.float32)  # 1 GB
    results = {"rows_small": N_SMALL, "tile": TILE, "nnz_row": NNZ_ROW}

    bw, _ = bw_probe(probe)
    print(f"# read-BW probe: {bw:.1f} GB/s", file=sys.stderr)
    results["bw_before_small"] = round(bw, 1)

    run("small", native, indptr_s, indices_s, data_s, gene_idx, buckets,
        weights, Xsk, results)

    n_big = N_SMALL * TILE
    print(f"# tiling to {n_big} rows "
          f"({n_big * NNZ_ROW / 1e9:.1f}B nnz, "
          f"{n_big * NNZ_ROW * 12 / 2**30:.0f} GiB f32 data + i64 "
          "indices)...", file=sys.stderr)
    t0 = time.perf_counter()
    indices_b = np.tile(indices_s, TILE)
    data_b = np.tile(data_s, TILE)
    indptr_b = np.arange(n_big + 1, dtype=np.int64) * NNZ_ROW
    del indices_s, data_s
    print(f"# tiled in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    bw, _ = bw_probe(probe)
    print(f"# read-BW probe: {bw:.1f} GB/s", file=sys.stderr)
    results["bw_before_big"] = round(bw, 1)

    run("big", native, indptr_b, indices_b, data_b, gene_idx, buckets,
        weights, Xsk, results)

    bw, _ = bw_probe(probe)
    results["bw_after_big"] = round(bw, 1)
    print(f"# read-BW probe: {bw:.1f} GB/s", file=sys.stderr)

    results["ratio_xty"] = round(
        results["big_xty_ns_per_nnz"] / results["small_xty_ns_per_nnz"], 2
    )
    results["ratio_moments"] = round(
        results["big_moments_ns_per_nnz"]
        / results["small_moments_ns_per_nnz"], 2
    )
    print(json.dumps(results))


if __name__ == "__main__":
    main()
