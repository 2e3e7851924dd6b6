"""Synthetic datasets and the restart-deterministic data pipeline (numpy)."""
