"""Cohere Command R+ 104B: dense GQA, parallel blocks, no biases.
[hf:CohereForAI/c4ai-command-r-v01; unverified] (``repro/configs/command_r_plus_104b.py``)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="command-r-plus-104b",
    family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab=256000,
    layout="a", qkv_bias=False, norm="ln", parallel_block=True,
    activation="silu", ffn_kind="gated", tie_embeddings=True,
    rope_theta=75_000_000.0,
    notes="command-r parallel attn+FFN block; LayerNorm; tied embeddings",
)
