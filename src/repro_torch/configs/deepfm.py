"""deepfm [arXiv:1703.04247; paper]
n_sparse=39 embed_dim=10 mlp=400-400-400, FM interaction (Criteo).
Field vocabs: hashed Criteo layout ~1.1M total features (paper §IV)."""
from repro_torch.configs import base
from repro_torch.models.recsys import DeepFMConfig

# 13 numeric fields bucketized + 26 categorical; hashed sizes sum ≈ 1.09M
_ROWS = tuple([64] * 13 + [
    1461, 584, 10_131_227 // 100, 2_202_608 // 100, 306, 24, 12518, 634, 4,
    93146, 5684, 8_351_593 // 100, 3195, 28, 14993, 5_461_306 // 100, 11,
    5653, 2173, 4, 7_046_547 // 100, 18, 16, 286181, 105, 142572,
])


def make_config() -> DeepFMConfig:
    return DeepFMConfig(name="deepfm", row_counts=_ROWS, embed_dim=10,
                        mlp=(400, 400, 400))


def make_reduced() -> DeepFMConfig:
    return DeepFMConfig(name="deepfm-reduced", row_counts=tuple([50] * 8),
                        embed_dim=4, mlp=(16, 16))


base.register(base.ArchSpec(
    arch_id="deepfm", family="recsys", make_config=make_config,
    make_reduced=make_reduced, shapes=base.RECSYS_SHAPES,
    source="arXiv:1703.04247; paper"))
