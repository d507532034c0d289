"""granite-3-8b [hf:ibm-granite/granite-3.0-2b-base family; hf]
40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155 — dense GQA LM."""
import torch
from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(name="granite-3-8b", n_layers=40, d_model=4096,
                    n_heads=32, n_kv_heads=8, d_head=128, d_ff=12800,
                    vocab=49155, microbatches=16)


def make_reduced() -> LMConfig:
    return LMConfig(name="granite-3-8b-reduced", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_head=16, d_ff=192, vocab=256,
                    microbatches=1, remat=False, dtype=torch.float32)


base.register(base.ArchSpec(
    arch_id="granite-3-8b", family="lm", make_config=make_config,
    make_reduced=make_reduced, shapes=base.LM_SHAPES,
    source="hf:ibm-granite/granite-3.0-2b-base; hf"))
