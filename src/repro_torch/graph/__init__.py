"""Graph analytics over BaM-backed CSR edge lists."""
from repro_torch.graph.analytics import (BamGraph, bfs, bfs_oracle, cc,
                                         cc_oracle, random_graph)

__all__ = ["BamGraph", "bfs", "bfs_oracle", "cc", "cc_oracle",
           "random_graph"]
