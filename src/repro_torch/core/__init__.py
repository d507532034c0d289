"""The paper's primary contribution: end-to-end routing-guided learned PQ.
Port of ``repro/core``.

rotation.py   adaptive vector decomposition (skew-symmetric expm rotation)
quantizer.py  differentiable quantizer (soft assign + Gumbel-ST, Eq. 6-7)
features.py   n-propagation + routing-feature sampling (Alg. 1-2, Def. 4-6)
losses.py     neighborhood/routing/joint losses (Eq. 8-11)
trainer.py    multi-feature joint training (Adam + one-cycle, Fig. 2)
rpq.py        one-call API: train_rpq(...)
"""
from repro_torch.core.quantizer import RPQConfig, RPQParams  # noqa: F401
from repro_torch.core.rpq import RPQ, train_rpq  # noqa: F401
from repro_torch.core.trainer import TrainConfig, fit, init_rpq, to_model  # noqa: F401
