"""llama3-405b [arXiv:2407.21783; unverified]
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256."""
import torch
from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(name="llama3-405b", n_layers=126, d_model=16384,
                    n_heads=128, n_kv_heads=8, d_head=128, d_ff=53248,
                    vocab=128256, rope_theta=500000.0,
                    # the reference's memory settings for 405B: bf16 slots and grads,
                    microbatches=16, opt_slot_dtype=torch.bfloat16,
                    grad_dtype=torch.bfloat16, layer_block=7)  # remat blocks of 7


def make_reduced() -> LMConfig:
    return LMConfig(name="llama3-405b-reduced", n_layers=3, d_model=128,
                    n_heads=8, n_kv_heads=2, d_head=16, d_ff=416, vocab=512,
                    microbatches=2, remat=True, dtype=torch.float32)


base.register(base.ArchSpec(
    arch_id="llama3-405b", family="lm", make_config=make_config,
    make_reduced=make_reduced, shapes=base.LM_SHAPES,
    source="arXiv:2407.21783; unverified"))
