"""beam_rounds.offline: mean round trips of a search call (program counter)."""

from perfbench.readers import beam_rounds as read  # noqa: F401
