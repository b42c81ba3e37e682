from .pipeline import ShardedLoader
