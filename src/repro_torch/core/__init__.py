"""Qm.n format math, quantization policy and weight integerization."""
