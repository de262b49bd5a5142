"""Data-parallel ranks: one process (or, in the tests, one thread) per
device, each holding a full replica of the fields and poses and
computing on its share of the ray and track rows.

Counterpart of ``level_s2fm_tpu/parallel/``: ``mesh`` holds the active
group and the row sharding, ``distributed`` the collectives, the host
broadcasts and the launcher."""
from .mesh import (DataGroup, get_group, replicate, set_group,  # noqa: F401
                   shard_rows, use_group)
