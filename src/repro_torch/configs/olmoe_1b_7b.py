"""olmoe-1b-7b [arXiv:2409.02060; hf]
16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304, MoE 64e top-8."""
import torch
from repro_torch.configs import base
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(name="olmoe-1b-7b", n_layers=16, d_model=2048,
                    n_heads=16, n_kv_heads=16, d_head=128, d_ff=1024,
                    vocab=50304,
                    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
                    microbatches=4)


def make_reduced() -> LMConfig:
    return LMConfig(name="olmoe-1b-7b-reduced", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=4, d_head=16, d_ff=64, vocab=256,
                    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                                  group_size=64),
                    microbatches=1, remat=False, dtype=torch.float32)


base.register(base.ArchSpec(
    arch_id="olmoe-1b-7b", family="lm", make_config=make_config,
    make_reduced=make_reduced, shapes=base.LM_SHAPES,
    source="arXiv:2409.02060; hf"))
