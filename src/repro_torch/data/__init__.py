from .pipeline import SyntheticLM, host_shard  # noqa: F401
