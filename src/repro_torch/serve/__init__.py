from repro_torch.serve.engine import (Clock, Request, ServeEngine,
                                      VirtualClock, validate_request)
from repro_torch.serve.kv_alloc import PagedKVAllocator
from repro_torch.serve.loadgen import bursty_trace, make_trace, poisson_trace
from repro_torch.serve.scheduler import ServeScheduler

__all__ = ["ServeEngine", "Request", "ServeScheduler", "PagedKVAllocator",
           "Clock", "VirtualClock", "validate_request", "poisson_trace",
           "bursty_trace", "make_trace"]
