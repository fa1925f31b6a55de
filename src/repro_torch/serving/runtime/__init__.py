"""repro_torch.serving.runtime — continuous-batching serving on top of
the segment-wise token step.

Streaming `Request`s queue up (`request.py`), the lane scheduler admits
them into the batched step gated by the paged pool's free-page budget
and recycles a lane the moment its request completes (`scheduler.py`),
seeded synthetic traffic drives it (`workload.py`), and serving metrics
— throughput, token-latency percentiles, TTFT, goodput under an SLO,
segments saved — come out as JSON (`metrics.py`).  `server.py` ties the
loop together.
"""

from repro_torch.serving.runtime.metrics import RuntimeMetrics
from repro_torch.serving.runtime.request import Request, RequestQueue
from repro_torch.serving.runtime.scheduler import (ChunkPlanner,
                                                   EngineStepper,
                                                   LaneScheduler)
from repro_torch.serving.runtime.server import Server, build_bank
from repro_torch.serving.runtime.workload import (available_workloads,
                                                  make_workload)

__all__ = [
    "Request", "RequestQueue", "LaneScheduler", "ChunkPlanner",
    "EngineStepper", "Server", "RuntimeMetrics", "build_bank",
    "make_workload", "available_workloads",
]
