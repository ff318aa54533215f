from repro_torch.serve.engine import (AdmissionPool, GenerationResult, PrefillPipeline,
                                     ServeEngine)
from repro_torch.serve.scheduler import (ContinuousScheduler, Request,
                                         RequestError, StreamEvent)
from repro_torch.serve.state_store import (PrefixCache, SegmentSnapshot, SessionEntry,
                                           SessionEvicted, SessionStore, prefix_hash_chain)
from repro_torch.serve.telemetry import (MetricsRegistry, Telemetry, TraceRecorder,
                                         default_registry, validate_chrome_trace)

__all__ = ["AdmissionPool", "ContinuousScheduler", "GenerationResult", "MetricsRegistry",
           "PrefillPipeline", "PrefixCache", "Request", "RequestError", "SegmentSnapshot",
           "ServeEngine", "SessionEntry", "SessionEvicted", "SessionStore", "StreamEvent",
           "Telemetry", "TraceRecorder", "default_registry", "prefix_hash_chain",
           "validate_chrome_trace"]
