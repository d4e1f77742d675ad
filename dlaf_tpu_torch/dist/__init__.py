from . import index
from .distribution import Distribution
from .layout import gather_from_shards, local_shard, scatter_to_shards

__all__ = ["index", "Distribution", "scatter_to_shards", "gather_from_shards",
           "local_shard"]
