"""GLM-4 9B: dense GQA kv=2, RoPE, QKV bias. [hf:THUDM/glm-4-9b]
(``repro/configs/glm4_9b.py``)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="glm4-9b",
    family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab=151552,
    layout="a", qkv_bias=True, norm="rms", activation="silu",
    ffn_kind="gated", tie_embeddings=True,
)
