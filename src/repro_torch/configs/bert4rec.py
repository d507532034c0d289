"""bert4rec [arXiv:1904.06690; paper]
embed_dim=64 n_blocks=2 n_heads=2 seq_len=200, bidirectional self-attn.
Item vocab: ML-20M (26744 items) as in the paper's largest benchmark."""
from repro_torch.configs import base
from repro_torch.models.recsys import Bert4RecConfig


def make_config() -> Bert4RecConfig:
    return Bert4RecConfig(name="bert4rec", n_items=26744, embed_dim=64,
                          n_blocks=2, n_heads=2, seq_len=200)


def make_reduced() -> Bert4RecConfig:
    return Bert4RecConfig(name="bert4rec-reduced", n_items=500, embed_dim=16,
                          n_blocks=2, n_heads=2, seq_len=20)


base.register(base.ArchSpec(
    arch_id="bert4rec", family="recsys", make_config=make_config,
    make_reduced=make_reduced, shapes=base.RECSYS_SHAPES,
    source="arXiv:1904.06690; paper"))
