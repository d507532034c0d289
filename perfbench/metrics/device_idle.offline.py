"""device_idle.offline: percent of the traced window with nothing running on the card."""

from perfbench.readers import device_idle as read  # noqa: F401
