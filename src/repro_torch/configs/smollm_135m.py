"""SmolLM-135M: llama-arch small dense GQA. [hf:HuggingFaceTB/SmolLM-135M]
(``repro/configs/smollm_135m.py``)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="smollm-135m",
    family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab=49152,
    layout="a", norm="rms", activation="silu", ffn_kind="gated",
    tie_embeddings=True,
    notes="9 heads is not TP16-divisible: head-axis constraints fall back to "
          "flat-dim sharding (dist/sharding.py divisibility rule)",
)
