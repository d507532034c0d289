"""din [arXiv:1706.06978; paper]
embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80 target-attention.
Item vocab: Amazon(Electronics) 63001 goods as in the paper."""
from repro_torch.configs import base
from repro_torch.models.recsys import DINConfig


def make_config() -> DINConfig:
    return DINConfig(name="din", n_items=63001, embed_dim=18, seq_len=100,
                     attn_mlp=(80, 40), mlp=(200, 80))


def make_reduced() -> DINConfig:
    return DINConfig(name="din-reduced", n_items=300, embed_dim=8, seq_len=12,
                     attn_mlp=(16, 8), mlp=(16, 8))


base.register(base.ArchSpec(
    arch_id="din", family="recsys", make_config=make_config,
    make_reduced=make_reduced, shapes=base.RECSYS_SHAPES,
    source="arXiv:1706.06978; paper"))
