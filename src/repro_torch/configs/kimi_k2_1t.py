"""Kimi K2: trillion-param MoE, 61 layers, 384 experts top-8 + 1 shared, the
first layer dense. [arXiv:2501.kimi2; unverified, paper-table]
(``repro/configs/kimi_k2_1t.py``)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab=163840,
    layout="a", n_experts=384, top_k=8, n_shared_experts=1,
    moe_every=1, moe_offset=0, first_k_dense=1, d_ff_dense=18432,
    norm="rms", activation="silu", ffn_kind="gated", tie_embeddings=False,
    notes="EP: 24 experts/device on TP16; int8 weights are what makes 1T "
          "params servable in 512x16GiB (DESIGN.md flagship memory win)",
)
