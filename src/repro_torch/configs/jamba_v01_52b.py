"""Jamba v0.1 52B: Mamba + attention 1:7 interleave, MoE 16 experts top-2
every other layer. [arXiv:2403.19887; hf] (``repro/configs/jamba_v01_52b.py``)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    layout="mmmammmm",             # attention at period position 3 (1:7)
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    use_rope=False,                # jamba: no positional encoding in attn
    norm="rms", activation="silu", ffn_kind="gated", tie_embeddings=True,
    notes="SSM state fp32 (ssm_state in skip_kinds); runs long_500k",
)
