"""Qwen2.5-14B: dense GQA kv=8, QKV bias, untied head. [hf:Qwen/Qwen2.5]
(``repro/configs/qwen25_14b.py``)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2.5-14b",
    family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab=152064,
    layout="a", qkv_bias=True, norm="rms", activation="silu",
    ffn_kind="gated", tie_embeddings=False,
    notes="QKV bias quantized at accumulator width (paper Sec. 5.8); "
          "40 heads not TP16-divisible -> flat-dim sharding fallback",
)
