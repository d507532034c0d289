"""The architecture zoo. Port of ``repro/models``: the shared layers, the
dense and MoE decoder LMs with training, prefill and KV-cache decode
(``transformer``, ``moe``), GAT with its neighbour sampler (``gnn``), and
DLRM, DeepFM, DIN and Bert4Rec with the retrieval scorers (``recsys``)."""
