"""batch_queries.online: mean queries the dispatcher hands a search call."""

from perfbench.readers import batch_queries as read  # noqa: F401
