from repro_torch.serve.engine import GenerationResult, ServeEngine
from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                         RequestError, StreamEvent)

__all__ = ["ContinuousScheduler", "GenerationResult", "Request", "RequestError",
           "ServeEngine", "StreamEvent"]
