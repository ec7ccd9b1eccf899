from repro_torch.serve.graph_registry import GraphRegistry, RegisteredGraph
from repro_torch.serve.pagerank_service import (PageRankService, PPRQuery,
                                                PPRResult)
from repro_torch.serve.result_cache import ResultCache
from repro_torch.serve.scheduler import (AdmissionRejected, DeadlineScheduler,
                                         FifoScheduler, QueueEntry,
                                         SolveTimeEstimator, TenantSpec)

__all__ = ["GraphRegistry", "RegisteredGraph", "PageRankService", "PPRQuery",
           "PPRResult", "ResultCache", "AdmissionRejected", "DeadlineScheduler",
           "FifoScheduler", "QueueEntry", "SolveTimeEstimator", "TenantSpec"]
