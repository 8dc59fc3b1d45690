from repro_torch.serve.engine import (Clock, Request, ServeEngine,
                                      VirtualClock, validate_request)

__all__ = ["ServeEngine", "Request", "Clock", "VirtualClock",
           "validate_request"]
