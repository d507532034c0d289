"""gat-cora [arXiv:1710.10903; paper]
2L d_hidden=8 n_heads=8 attention aggregator (Cora: 1433 feats, 7 classes)."""
from repro_torch.configs import base
from repro_torch.models.gnn import GATConfig


def make_config() -> GATConfig:
    return GATConfig(name="gat-cora", d_in=1433, d_hidden=8, n_heads=8,
                     n_layers=2, n_classes=7)


def make_reduced() -> GATConfig:
    return GATConfig(name="gat-cora-reduced", d_in=32, d_hidden=4, n_heads=2,
                     n_layers=2, n_classes=4)


base.register(base.ArchSpec(
    arch_id="gat-cora", family="gnn", make_config=make_config,
    make_reduced=make_reduced, shapes=base.GNN_SHAPES,
    source="arXiv:1710.10903; paper",
    notes="minibatch_lg/ogb_products reuse the same 2L-GAT with the shape's "
          "d_feat (the paper's model is feature-width agnostic)"))
