from repro_torch.dist.fault import (ChaosPlan, FailureInjector, InjectedFailure,
                                    MergedTopK, QuorumDecision, partial_merge,
                                    resolve_quorum, supervise)

__all__ = ["ChaosPlan", "FailureInjector", "InjectedFailure", "MergedTopK",
           "QuorumDecision", "partial_merge", "resolve_quorum", "supervise"]
