"""starcoder2-3b [arXiv:2402.19173; hf]
30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 — GQA, RoPE."""
import torch
from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(name="starcoder2-3b", n_layers=30, d_model=3072,
                    n_heads=24, n_kv_heads=2, d_head=128, d_ff=12288,
                    vocab=49152, microbatches=16)


def make_reduced() -> LMConfig:
    return LMConfig(name="starcoder2-3b-reduced", n_layers=2, d_model=96,
                    n_heads=6, n_kv_heads=2, d_head=16, d_ff=384, vocab=256,
                    microbatches=1, remat=False, dtype=torch.float32)


base.register(base.ArchSpec(
    arch_id="starcoder2-3b", family="lm", make_config=make_config,
    make_reduced=make_reduced, shapes=base.LM_SHAPES,
    source="arXiv:2402.19173; hf"))
