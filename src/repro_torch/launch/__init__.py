"""Command-line drivers of the port: ``train`` (fault-tolerant RPQ
training with checkpoints) and ``serve`` (restore the latest checkpoint
and serve queries). Port of ``repro/launch``."""
