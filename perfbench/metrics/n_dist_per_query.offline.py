"""n_dist_per_query.offline: mean distance evaluations per query (program counter)."""

from perfbench.readers import n_dist_per_query as read  # noqa: F401
