"""Continuous-batching split-inference serving (port of
``repro.serving``).

* :mod:`repro_torch.serving.engine` - the engine step and its state.
* :mod:`repro_torch.serving.runners` - single-device / pipeline backends.
* :mod:`repro_torch.serving.batching` - static batched generate, the
  static baseline and the bit-identity reference.
* :mod:`repro_torch.serving.service` - host-side queue, slot scheduler,
  service loop, Poisson traces.
* :mod:`repro_torch.serving.replanner` - online split re-scoring.
* :mod:`repro_torch.serving.config` - engine and service knobs, JSON.
"""
from repro_torch.serving.batching import (decode_python_loop, generate_reference,
                                          generate_static, sample_token)
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import (EngineState, evict_slots,
                                        init_engine_state, make_engine_step)
from repro_torch.serving.replanner import OnlineReplanner
from repro_torch.serving.runners import PipelineRunner, SingleDeviceRunner
from repro_torch.serving.service import (Request, RequestQueue, ServingService,
                                         SlotScheduler, poisson_trace)

__all__ = [
    "EngineState", "OnlineReplanner", "PipelineRunner", "Request",
    "RequestQueue", "ServeConfig", "ServingService", "SingleDeviceRunner",
    "SlotScheduler", "decode_python_loop", "evict_slots",
    "generate_reference", "generate_static", "init_engine_state",
    "make_engine_step", "poisson_trace", "sample_token",
]
