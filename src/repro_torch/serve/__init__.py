"""Serving: the lockstep engine and the restart-the-batch policy."""
from repro_torch.serve.engine import ServeEngine, mask_vocab_tail, sample_tokens
from repro_torch.serve.scheduler import (Request, RequestResult, ServeStats,
                                         run_restart_batching)

__all__ = ["ServeEngine", "mask_vocab_tail", "sample_tokens", "Request",
           "RequestResult", "ServeStats", "run_restart_batching"]
