"""Shared substrate of the port: the optimizer, its schedules and the
helpers over parameter tuples. Port of ``repro/common`` (``sgd``,
``cosine_schedule`` and ``warmup_cosine`` wait for the model zoo)."""

from repro_torch.common.optim import (  # noqa: F401
    OptState,
    Optimizer,
    adam,
    clip_by_global_norm,
    constant_schedule,
    one_cycle,
)
from repro_torch.common.treeutil import global_norm  # noqa: F401
