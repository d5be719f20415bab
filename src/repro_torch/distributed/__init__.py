"""Distributed tooling: the sharding rules on a ``DeviceMesh``, gradient
compression, and the fault-tolerance supervisor (the reference package's
``distributed``)."""

from .compression import (compress_with_feedback, compressed_psum, decode,
                          encode, init_error_feedback,
                          make_crosspod_grad_transform)
from .fault_tolerance import (HeartbeatMonitor, MeshPlan, RecoveryAction,
                              StragglerDetector, Supervisor,
                              plan_elastic_mesh)
from .sharding import (batch_shardings, cache_shardings, param_shardings,
                       replicated)

__all__ = [
    "HeartbeatMonitor", "MeshPlan", "RecoveryAction", "StragglerDetector",
    "Supervisor", "batch_shardings", "cache_shardings",
    "compress_with_feedback", "compressed_psum", "decode", "encode",
    "init_error_feedback", "make_crosspod_grad_transform",
    "param_shardings", "plan_elastic_mesh", "replicated",
]
