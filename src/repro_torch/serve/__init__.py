"""Serving layer: the LM engine on the request-scheduling substrate."""

from .engine import Completion, Engine, Request, decode, prefill, sample
from .scheduling import plan_batches

__all__ = ["Completion", "Engine", "Request", "decode", "prefill", "sample",
           "plan_batches"]
