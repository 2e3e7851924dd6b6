"""Phi-3.5-MoE 42B (6.6B active): 16 experts top-2 every layer.
[hf:microsoft/Phi-3.5-MoE-instruct; hf] (``repro/configs/phi35_moe_42b.py``)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab=32064,
    layout="a", n_experts=16, top_k=2, moe_every=1, moe_offset=0,
    norm="ln", activation="silu", ffn_kind="gated", tie_embeddings=False,
    notes="EP: 1 expert/device on the 16-way model axis; router kept fp32",
)
