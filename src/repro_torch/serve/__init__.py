"""Serving: the engine, the continuous-batching scheduler and the
restart-the-batch baseline."""
from repro_torch.serve.engine import ServeEngine, mask_vocab_tail, sample_tokens
from repro_torch.serve.scheduler import (Request, RequestResult, Scheduler, ServeStats,
                                         run_restart_batching)

__all__ = ["ServeEngine", "mask_vocab_tail", "sample_tokens", "Request",
           "RequestResult", "Scheduler", "ServeStats", "run_restart_batching"]
