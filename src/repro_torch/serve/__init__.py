"""Serving layer: the LM engine and the archive HTTP service
(:mod:`repro_torch.serve.http`), both on the
:mod:`repro_torch.serve.scheduling` request-scheduling substrate."""

from .engine import Completion, Engine, Request, decode, prefill, sample
from .http import (ApiError, ArchiveServer, ArchiveService, create_app,
                   decode_payload, encode_product)
from .scheduling import ByteBudgetCache, SingleFlight, plan_batches

__all__ = [
    "Completion", "Engine", "Request", "decode", "prefill", "sample",
    "ApiError", "ArchiveServer", "ArchiveService", "create_app",
    "decode_payload", "encode_product",
    "ByteBudgetCache", "SingleFlight", "plan_batches",
]
