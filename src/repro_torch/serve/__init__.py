"""Serving: the engine, the continuous-batching scheduler and the
restart-the-batch baseline, with hardened serving's fault plans and
invariant auditor, over KV caches, recurrent state and cached EncDec
cross-attention."""
from repro_torch.serve.audit import (AuditError, check_allocator, check_cross_lens,
                                     check_page_tables, check_recurrent_rows, check_swap)
from repro_torch.serve.engine import ServeEngine, mask_vocab_tail, sample_tokens
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.scheduler import (STATUSES, Request, RequestResult, Scheduler,
                                         ServeStats, run_restart_batching)
from repro_torch.serve.slot_state import state_bytes_per_slot, state_kinds

__all__ = ["ServeEngine", "mask_vocab_tail", "sample_tokens", "Request",
           "RequestResult", "Scheduler", "ServeStats", "run_restart_batching", "STATUSES",
           "FaultPlan", "AuditError", "check_allocator", "check_page_tables", "check_swap",
           "check_recurrent_rows", "check_cross_lens", "state_bytes_per_slot", "state_kinds"]
