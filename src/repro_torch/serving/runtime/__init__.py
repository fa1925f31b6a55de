"""repro_torch.serving.runtime — continuous-batching serving on top of
the segment-wise token step.

Streaming `Request`s queue up (`request.py`), the lane scheduler admits
them into the batched step gated by the paged pool's free-page budget
and recycles a lane the moment its request completes (`scheduler.py`),
seeded synthetic traffic drives it (`workload.py`), and serving metrics
— throughput, token-latency percentiles, TTFT, goodput under an SLO,
segments saved — come out as JSON (`metrics.py`).  `server.py` ties the
loop together and adds a model-free simulation stepper that replays
loss traces through the same scheduler on a virtual clock.
"""

from repro_torch.serving.runtime.metrics import RuntimeMetrics
from repro_torch.serving.runtime.request import Request, RequestQueue
from repro_torch.serving.runtime.scheduler import (ChunkPlanner,
                                                   EngineStepper,
                                                   LaneScheduler)
from repro_torch.serving.runtime.server import (Server, SimStepper,
                                                build_bank, cascade_factory)
from repro_torch.serving.runtime.workload import (available_workloads,
                                                  make_workload)

__all__ = [
    "Request", "RequestQueue", "LaneScheduler", "ChunkPlanner",
    "EngineStepper", "Server", "SimStepper", "RuntimeMetrics",
    "build_bank", "cascade_factory", "make_workload",
    "available_workloads",
]
