"""Distributed tooling: so far the fault-tolerance supervisor.

Sharding, gradient compression and the mesh's decode core are ROADMAP
item 8.3 ("Modules to port").
"""

from .fault_tolerance import (HeartbeatMonitor, MeshPlan, RecoveryAction,
                              StragglerDetector, Supervisor,
                              plan_elastic_mesh)

__all__ = ["HeartbeatMonitor", "MeshPlan", "RecoveryAction",
           "StragglerDetector", "Supervisor", "plan_elastic_mesh"]
