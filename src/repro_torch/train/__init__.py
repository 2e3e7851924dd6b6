"""Training: the QAT-aware steps and checkpointing."""
