"""Mamba 130M: a pure selective-SSM stack at smollm scale, the smallest
servable recurrent config (constant per-slot state, no KV cache).
[arXiv:2312.00752; hf] (``repro/configs/mamba_130m.py``)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba-130m",
    family="ssm",
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=2048, vocab=50280,
    layout="m", norm="rms", ffn_kind="gated", tie_embeddings=True,
    notes="attention-free: per-slot decode state is a fixed (d_inner, "
          "d_state) matrix + conv tail (serve/slot_state.py RecurrentState) "
          "— bytes/slot constant in sequence length; serves through the "
          "chunked continuous-batching loop",
)
