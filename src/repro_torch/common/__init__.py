"""Shared substrate of the port: the optimizers, their schedules and the
helpers over parameter trees. Port of ``repro/common``."""

from repro_torch.common.optim import (  # noqa: F401
    OptState,
    Optimizer,
    adam,
    clip_by_global_norm,
    constant_schedule,
    cosine_schedule,
    one_cycle,
    sgd,
    warmup_cosine,
)
from repro_torch.common.treeutil import global_norm  # noqa: F401
