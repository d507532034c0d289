"""round_ms.offline: host wall time of the search calls per round trip (the
benchmark's clock around each call, over the program's round counter)."""

from perfbench.readers import round_ms as read  # noqa: F401
