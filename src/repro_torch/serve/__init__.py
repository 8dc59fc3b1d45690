from repro_torch.serve.engine import (Clock, Request, ServeEngine,
                                      VirtualClock, require_text_serving,
                                      validate_request)
from repro_torch.serve.kv_alloc import PagedKVAllocator
from repro_torch.serve.legacy import LegacyServeEngine
from repro_torch.serve.loadgen import bursty_trace, make_trace, poisson_trace
from repro_torch.serve.scheduler import ServeScheduler

__all__ = ["ServeEngine", "LegacyServeEngine", "Request", "ServeScheduler",
           "PagedKVAllocator", "Clock", "VirtualClock", "validate_request",
           "require_text_serving", "poisson_trace",
           "bursty_trace", "make_trace"]
