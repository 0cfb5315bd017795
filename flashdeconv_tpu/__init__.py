"""flashdeconv-tpu: accelerator-native spatial transcriptomics deconvolution.

A from-scratch JAX/XLA/Pallas reimplementation of the FlashDeconv method —
leverage-weighted CountSketch gene compression, sparse spatial-graph
Laplacian smoothing, and a graph-regularized NNLS solve via block coordinate
descent — run on one GPU or a mesh of several (spot-sharded ``shard_map``
BCD with halo exchange; see :mod:`flashdeconv_tpu.parallel`).

Quick start (array API)::

    from flashdeconv_tpu import FlashDeconv
    model = FlashDeconv(sketch_dim=512)
    proportions = model.fit_transform(Y, X, coords)   # (n_spots, n_types)

Quick start (scanpy-style API)::

    import flashdeconv_tpu as fd
    fd.tl.deconvolve(adata_st, adata_ref, cell_type_key="cell_type")
    adata_st.obsm["flashdeconv"]                       # proportions
"""

__version__ = "0.5.0"

import os as _os


def _setup_compilation_cache() -> None:
    """Enable JAX's persistent compilation cache.

    Each (n_spots, K, graph structure) shape compiles its own solver
    executable; the persistent cache makes that a one-time cost. A
    ``JAX_COMPILATION_CACHE_DIR`` set in the environment is used as it is
    (JAX reads it itself). Otherwise the cache lives at a fixed path inside
    the checkout, ``<repo>/.jax_cache`` (listed in ``.gitignore``): the
    path is part of the cache key, so it must not move between runs.
    """
    import jax

    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    cache_dir = _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_setup_compilation_cache()

from flashdeconv_tpu.core.deconv import FlashDeconv
from flashdeconv_tpu import pl, tl

__all__ = ["FlashDeconv", "tl", "pl", "__version__"]
