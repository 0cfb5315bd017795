"""Multi-device scaling layer: spot sharding, halo exchange, mesh solve.

The reference implementation is single-process (SURVEY.md: no distributed
code anywhere); this package is the multi-device scaling design — a 1-D
device mesh over the spot axis, locality-preserving graph partitioning,
per-sweep boundary-row halo exchange, and ``pmax`` convergence reductions.
"""

from flashdeconv_tpu.parallel import multihost
from flashdeconv_tpu.parallel.gspmd import GspmdBandedProblem, gspmd_banded_solve
from flashdeconv_tpu.parallel.ordering import morton_codes, morton_order, spot_order
from flashdeconv_tpu.parallel.partition import ShardPlan, halo_fraction, plan_shards
from flashdeconv_tpu.parallel.solver import (
    HaloShardedProblem,
    ShardedBCDProblem,
    default_mesh,
    prepare_sharded_bcd,
    sharded_bcd_solve,
)

__all__ = [
    "GspmdBandedProblem",
    "HaloShardedProblem",
    "ShardedBCDProblem",
    "ShardPlan",
    "default_mesh",
    "gspmd_banded_solve",
    "halo_fraction",
    "morton_codes",
    "morton_order",
    "multihost",
    "plan_shards",
    "prepare_sharded_bcd",
    "sharded_bcd_solve",
    "spot_order",
]
