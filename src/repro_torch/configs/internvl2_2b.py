"""InternVL2-2B: InternLM2-1.8B backbone + InternViT stub patch embeddings.
[arXiv:2404.16821] (``repro/configs/internvl2_2b.py``)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="internvl2-2b",
    family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92553,
    layout="a", vis_seq=256,
    norm="rms", activation="silu", ffn_kind="gated", tie_embeddings=True,
    notes="vision prefix = 256 stub patch embeddings prepended to the text "
          "tokens; only text logits are scored",
)
