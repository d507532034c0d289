"""dlrm-mlperf [arXiv:1906.00091; paper] — MLPerf DLRM (Criteo 1TB).
n_dense=13 n_sparse=26 embed_dim=128 bot=13-512-256-128
top=1024-1024-512-256-1 dot interaction. Table rows: official MLPerf
day-count cardinalities (≈188M rows, ≈24B embedding params)."""
from repro_torch.configs import base
from repro_torch.models.recsys import DLRMConfig

# MLPerf v1.0 DLRM Criteo-1TB per-table cardinalities
_ROWS = (39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
         2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
         25641295, 39664984, 585935, 12972, 108, 36)


def make_config() -> DLRMConfig:
    return DLRMConfig(name="dlrm-mlperf", n_dense=13, row_counts=_ROWS,
                      embed_dim=128, bot_mlp=(512, 256, 128),
                      top_mlp=(1024, 1024, 512, 256, 1))


def make_reduced() -> DLRMConfig:
    return DLRMConfig(name="dlrm-reduced", n_dense=13,
                      row_counts=tuple([100] * 6), embed_dim=16,
                      bot_mlp=(32, 16), top_mlp=(32, 16, 1))


base.register(base.ArchSpec(
    arch_id="dlrm-mlperf", family="recsys", make_config=make_config,
    make_reduced=make_reduced, shapes=base.RECSYS_SHAPES,
    source="arXiv:1906.00091; paper"))
