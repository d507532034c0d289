"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8."""
import torch
from repro_torch.configs import base
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(name="granite-moe-1b-a400m", n_layers=24, d_model=1024,
                    n_heads=16, n_kv_heads=8, d_head=64, d_ff=512,
                    vocab=49155,
                    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
                    microbatches=4)


def make_reduced() -> LMConfig:
    return LMConfig(name="granite-moe-1b-a400m-reduced", n_layers=2,
                    d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=64,
                    vocab=256,
                    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                                  group_size=64),
                    microbatches=1, remat=False, dtype=torch.float32)


base.register(base.ArchSpec(
    arch_id="granite-moe-1b-a400m", family="lm", make_config=make_config,
    make_reduced=make_reduced, shapes=base.LM_SHAPES,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf"))
