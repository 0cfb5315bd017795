"""One BCD sweep as a single Pallas kernel for NVIDIA GPUs (Triton route).

The XLA sweep (:func:`flashdeconv_tpu.ops.bcd.coordinate_descent`) runs
the Gauss-Seidel coordinate loop as K separate whole-array steps: each
coordinate reads and rewrites the full (N, K) residual and a strided column
of beta in device memory, so one sweep moves about K times the bytes of a
streaming pass. This kernel keeps every spot's coordinates in registers
for the whole coordinate loop instead:

* each program owns a tile of spots of the transposed (K, N) beta as one
  (KP, block) register tile (KP = K rounded up to a power of two, the
  padding rows masked), so every load across spots is contiguous
  (coalesced) and each thread holds whole spot columns;
* the neighbour sum is read straight from the OLD beta in global memory —
  one tile load per static band offset under the uint8 band masks, one
  gather per slot of the padded remainder table (padding == N) — and folded
  with Xty into the coordinate-order-independent part of the numerator
  before the loop. The read and write buffers never alias (Jacobi across
  spots, Gauss-Seidel within a spot: the reference's iterate, reference
  ``flashdeconv/core/solver.py:29-184``); L2 absorbs the neighbour reuse,
  and nothing depends on program order;
* the K coordinates run as a rolled loop: coordinate k's residual is the
  dot of row k of XtX (diagonal zeroed) with the current tile, so the
  kernel's size, and its compile time, do not grow with K;
* ragged tails are masked loads and stores, not padding;
* each program writes its max |delta beta| and max |beta_old| to an
  ``(n_programs,)`` output that one ``jnp.max`` reduces.

The update per coordinate is the XLA path's formula
(``max(resid - rho, 0) / den`` behind the ``den > 1e-10`` guard); only the
order of the f32 sums differs, so kernel and XLA agree to float32 rounding,
not bitwise. Precision is true FP32 throughout (no tensor cores involved).

``interpret=True`` runs the kernel through the Pallas interpreter on the
CPU; only tests pass it.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from flashdeconv_tpu.ops.bcd import converge_loop

#: Largest K the kernel takes. Each thread holds its spots' (KP,) beta and
#: numerator columns plus one XtX row, so register use grows with K (and
#: spills past KP = 64); it still measured 4-5.5x faster than XLA's
#: rolled sweep at K = 128 on an H100 (PERF.md). Above this the XLA tiers run.
KERNEL_MAX_K = 128

#: One warp per program (the fastest of the tilings measured on an H100,
#: PERF.md).
_NUM_WARPS = 1


def _block(n_types: int) -> int:
    """Spots per program: two spot columns per thread while the padded K
    is at most 32 (fastest at K = 20), one column above (at K = 128 two
    columns per thread spill registers and ran 7.5x slower, PERF.md)."""
    from jax.experimental import pallas as pl

    return 64 if pl.next_power_of_2(n_types) <= 32 else 32


def _make_kernel(n_types: int, offsets: Tuple[int, ...], n_rest: int,
                 block: int):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    kp = pl.next_power_of_2(n_types)

    def kernel(lam_ref, rho_ref, beta_ref, xty_ref, xtx_ref, nnb_ref, *refs):
        refs = list(refs)
        masks_ref = refs.pop(0) if offsets else None
        rest_ref = refs.pop(0) if n_rest else None
        out_ref, diff_ref, abs_ref = refs

        n = beta_ref.shape[1]
        pid = pl.program_id(0)
        idx = pid * block + jnp.arange(block, dtype=jnp.int32)
        valid = idx < n
        rows = jnp.arange(kp, dtype=jnp.int32)[:, None]        # (KP, 1)
        cols = jnp.arange(kp, dtype=jnp.int32)                  # (KP,)
        tile_ok = (rows < n_types) & valid[None, :]             # (KP, B)
        lam = lam_ref[0]
        rho = rho_ref[0]

        old = plgpu.load(beta_ref.at[rows, idx[None, :]], mask=tile_ok,
                         other=0.0)
        # Neighbour sum of the old beta: bands, then the remainder slots.
        ns = jnp.zeros((kp, block), jnp.float32)
        for u, off in enumerate(offsets):
            m = plgpu.load(masks_ref.at[u, idx], mask=valid, other=0)
            j = idx + off
            ok = tile_ok & ((m != 0) & (j >= 0) & (j < n))[None, :]
            ns = ns + plgpu.load(beta_ref.at[rows, j[None, :]], mask=ok,
                                 other=0.0)
        if n_rest:
            rs = jnp.zeros((kp, block), jnp.float32)
            for r in range(n_rest):
                t = plgpu.load(rest_ref.at[r, idx], mask=valid, other=n)
                rs = rs + plgpu.load(
                    beta_ref.at[rows, t[None, :]],
                    mask=tile_ok & (t < n)[None, :], other=0.0,
                )
            ns = ns + rs
        xty = plgpu.load(xty_ref.at[rows, idx[None, :]], mask=tile_ok,
                         other=0.0)
        num = xty + lam * ns
        deg = plgpu.load(nnb_ref.at[idx], mask=valid, other=0.0)

        def coordinate(k, carry):
            cur, dmax = carry
            sel = rows == k
            # Row k of XtX with its diagonal zeroed: the residual of
            # coordinate k without its own term — updated values of the
            # coordinates < k, old values of those > k.
            xrow = plgpu.load(xtx_ref.at[k, cols], mask=cols < n_types,
                              other=0.0)
            xrow = jnp.where(cols == k, 0.0, xrow)
            s = jnp.sum(xrow[:, None] * cur, axis=0)
            num_k = jnp.sum(jnp.where(sel, num, 0.0), axis=0)
            old_k = jnp.sum(jnp.where(sel, cur, 0.0), axis=0)
            den = xtx_ref[k, k] + lam * deg
            new = jnp.where(
                den > 1e-10, jnp.maximum(num_k - s - rho, 0.0) / den, 0.0
            )
            dmax = jnp.maximum(dmax, jnp.abs(new - old_k))
            return jnp.where(sel, new[None, :], cur), dmax

        cur, dmax = lax.fori_loop(
            0, n_types, coordinate,
            (old, jnp.zeros((block,), jnp.float32)),
        )
        plgpu.store(out_ref.at[rows, idx[None, :]], cur, mask=tile_ok)
        diff_ref[pid] = jnp.max(jnp.where(valid, dmax, 0.0))
        abs_ref[pid] = jnp.max(jnp.abs(old))

    return kernel


def sweep(
    beta_t: jnp.ndarray,
    xty_t: jnp.ndarray,
    xtx: jnp.ndarray,
    nnb: jnp.ndarray,
    lam,
    rho,
    offsets: Tuple[int, ...] = (),
    masks: Optional[jnp.ndarray] = None,
    rest_t: Optional[jnp.ndarray] = None,
    interpret: bool = False,
):
    """One BCD sweep on the transposed layout.

    Parameters
    ----------
    beta_t, xty_t : (K, N) float32 — current beta (read-only) and Xty.
    xtx : (K, K) float32 Gram matrix.
    nnb : (N,) float32 neighbour counts.
    offsets : static band offsets; ``masks`` (U, N) uint8 0/1 per offset.
    rest_t : optional (R, N) int32 remainder neighbour table, padding == N.

    Returns ``(beta_new_t, max_diff, max_abs)``.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n_types, n = beta_t.shape
    n_rest = 0 if rest_t is None else int(rest_t.shape[0])
    block = _block(n_types)
    n_prog = pl.cdiv(n, block)
    operands = [
        jnp.reshape(jnp.asarray(lam, jnp.float32), (1,)),
        jnp.reshape(jnp.asarray(rho, jnp.float32), (1,)),
        beta_t, xty_t, xtx, nnb,
    ]
    if offsets:
        operands.append(masks)
    if n_rest:
        operands.append(rest_t)
    out, diff, mabs = pl.pallas_call(
        _make_kernel(n_types, tuple(offsets), n_rest, block),
        grid=(n_prog,),
        out_shape=(
            jax.ShapeDtypeStruct((n_types, n), jnp.float32),
            jax.ShapeDtypeStruct((n_prog,), jnp.float32),
            jax.ShapeDtypeStruct((n_prog,), jnp.float32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="bcd_sweep",
    )(*operands)
    return out, jnp.max(diff), jnp.max(mabs)


@partial(jax.jit, static_argnames=("offsets", "max_iter", "interpret"))
def bcd_iterate_kernel(
    beta0, Xty, XtX, nnb, lambda_, rho, tol, max_iter: int,
    offsets: Tuple[int, ...] = (), masks=None, rest=None, iter_cap=None,
    interpret: bool = False,
):
    """Solve loop over :func:`sweep`; same convergence semantics as
    :func:`flashdeconv_tpu.ops.bcd.bcd_iterate_banded`.

    Takes and returns the (N, K) layout of the other tiers; the (K, N)
    transposes happen once per call, outside the loop. ``rest`` is the
    (N, R) padded neighbour table (padding == N) — the remainder of a banded
    decomposition, or the whole graph when ``offsets`` is empty.
    """
    rest_t = None if rest is None or rest.shape[1] == 0 else rest.T
    xty_t = Xty.T
    beta_t, n_iter, rel = converge_loop(
        lambda b: sweep(
            b, xty_t, XtX, nnb, lambda_, rho, offsets, masks, rest_t,
            interpret=interpret,
        ),
        beta0.T, tol, max_iter, iter_cap=iter_cap,
    )
    return beta_t.T, n_iter, rel
