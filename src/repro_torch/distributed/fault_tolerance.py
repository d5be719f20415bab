"""Fault tolerance: heartbeats, straggler detection, elastic rescale plans.

At thousands of chips the framework must assume per-step failures.  The
pieces here are deliberately runtime-agnostic (they reason about *hosts*
and *step timings*, not devices) so the launcher can drive them on any
cluster manager; the recovery actions all bottom out in the two primitives
the Icechunk checkpoint store gives us:

* restart = restore latest committed snapshot (atomic, so always valid);
* elastic rescale = same snapshot restored under a different mesh
  (chunk-aligned partial reads make this a re-slice, not a re-download).

The reference package's module, standard library only, kept as it is.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

@dataclass
class HeartbeatMonitor:
    """Tracks per-host liveness from periodic beats."""

    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic
    _last: Dict[str, float] = field(default_factory=dict)

    def beat(self, host: str, at: Optional[float] = None) -> None:
        self._last[host] = self.clock() if at is None else at

    def hosts(self) -> List[str]:
        return sorted(self._last)

    def dead(self, now: Optional[float] = None) -> List[str]:
        now = self.clock() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout_s)

    def alive(self, now: Optional[float] = None) -> List[str]:
        now = self.clock() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t <= self.timeout_s)


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------

@dataclass
class StragglerDetector:
    """Flags hosts whose step times are persistent outliers.

    Median + MAD over a sliding window; a host is a straggler once its
    median step time exceeds ``threshold`` × fleet median for
    ``min_samples`` consecutive windows.  Robust to the global slowdowns
    (input stalls, checkpoint writes) that mean/stddev schemes misflag.
    """

    window: int = 20
    threshold: float = 1.5
    min_samples: int = 5
    _times: Dict[str, List[float]] = field(default_factory=dict)

    def record(self, host: str, step_time_s: float) -> None:
        buf = self._times.setdefault(host, [])
        buf.append(step_time_s)
        if len(buf) > self.window:
            del buf[0]

    @staticmethod
    def _median(xs: Sequence[float]) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def stragglers(self) -> List[str]:
        per_host = {h: self._median(t) for h, t in self._times.items()
                    if len(t) >= self.min_samples}
        if len(per_host) < 2:
            return []
        fleet = self._median(list(per_host.values()))
        if fleet <= 0:
            return []
        return sorted(h for h, m in per_host.items()
                      if m > self.threshold * fleet)


# ---------------------------------------------------------------------------
# elastic rescale planning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshPlan:
    """A device-mesh layout, possibly degraded by dropped hosts."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    n_devices: int
    dropped_hosts: Tuple[str, ...] = ()

    @property
    def degraded(self) -> bool:
        return bool(self.dropped_hosts)


def plan_elastic_mesh(
    n_healthy_devices: int,
    *,
    model_parallel: int,
    prefer_pods: int = 1,
    devices_per_pod: int = 256,
    dropped_hosts: Sequence[str] = (),
) -> MeshPlan:
    """Largest (pod, data, model) mesh that fits the healthy devices.

    Model parallelism is load-bearing (params are laid out over it), so the
    model axis is preserved and the data axis shrinks — the batch re-shards,
    gradients stay mathematically identical (mean over the same global
    batch, different device count).  Whole failed pods drop first.
    """
    if model_parallel <= 0 or n_healthy_devices < model_parallel:
        raise ValueError("not enough devices for the model axis")
    pods = min(prefer_pods, max(1, n_healthy_devices // devices_per_pod))
    while pods > 1 and n_healthy_devices < pods * model_parallel:
        pods -= 1
    per_pod = n_healthy_devices // pods
    data = per_pod // model_parallel
    # keep data a power of two so global batch splits evenly
    data = 1 << max(0, int(math.floor(math.log2(data)))) if data else 0
    if data < 1:
        raise ValueError("not enough devices per pod for the model axis")
    if pods > 1:
        return MeshPlan((pods, data, model_parallel),
                        ("pod", "data", "model"),
                        pods * data * model_parallel,
                        tuple(dropped_hosts))
    return MeshPlan((data, model_parallel), ("data", "model"),
                    data * model_parallel, tuple(dropped_hosts))


# ---------------------------------------------------------------------------
# supervisor: ties monitor + detector + checkpoints into a policy
# ---------------------------------------------------------------------------

@dataclass
class RecoveryAction:
    """One planned response to a host failure."""
    kind: str                   # "none" | "evict" | "restart" | "rescale"
    hosts: Tuple[str, ...] = ()
    mesh: Optional[MeshPlan] = None
    reason: str = ""


class Supervisor:
    """Decides the recovery action after each step (launcher policy loop).

    Policy: dead hosts → rescale to the healthy set from the latest
    checkpoint; persistent stragglers → evict (treat as dead next step) so
    one slow HBM doesn't gate every all-reduce on the pod.
    """

    def __init__(self, *, model_parallel: int, devices_per_host: int = 4,
                 prefer_pods: int = 1, devices_per_pod: int = 256,
                 heartbeat_timeout_s: float = 60.0):
        self.hb = HeartbeatMonitor(timeout_s=heartbeat_timeout_s)
        self.straggle = StragglerDetector()
        self.model_parallel = model_parallel
        self.devices_per_host = devices_per_host
        self.prefer_pods = prefer_pods
        self.devices_per_pod = devices_per_pod
        self._evicted: set = set()

    def observe(self, host: str, *, step_time_s: Optional[float] = None,
                at: Optional[float] = None) -> None:
        self.hb.beat(host, at)
        if step_time_s is not None:
            self.straggle.record(host, step_time_s)

    def decide(self, now: Optional[float] = None) -> RecoveryAction:
        dead = [h for h in self.hb.dead(now) if h not in self._evicted]
        stragglers = [h for h in self.straggle.stragglers()
                      if h not in self._evicted]
        if not dead and not stragglers:
            return RecoveryAction("none")
        lost = sorted(set(dead) | set(stragglers))
        self._evicted.update(lost)
        healthy = [h for h in self.hb.hosts() if h not in self._evicted]
        n_dev = len(healthy) * self.devices_per_host
        try:
            plan = plan_elastic_mesh(
                n_dev, model_parallel=self.model_parallel,
                prefer_pods=self.prefer_pods,
                devices_per_pod=self.devices_per_pod, dropped_hosts=lost)
        except ValueError:
            return RecoveryAction(
                "restart", tuple(lost),
                reason=f"lost {lost}; too few devices — wait for replacements"
            )
        kind = "rescale" if dead else "evict"
        return RecoveryAction(kind, tuple(lost), plan,
                              reason=f"dead={dead} stragglers={stragglers}")
