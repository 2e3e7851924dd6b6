"""SmolLM-135M: llama-arch small dense GQA. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab=49152,
    layout="a", norm="rms", activation="silu", ffn_kind="gated",
    tie_embeddings=True,
)
