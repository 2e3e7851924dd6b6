"""RWKV-6 "Finch" 7B: attention-free, data-dependent decay.
[arXiv:2404.05892; hf] (``repro/configs/rwkv6_7b.py``)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536,
    layout="r", norm="ln", ffn_kind="rwkv", tie_embeddings=True,
    notes="attention-free: KV-cache quantization inapplicable (state matrix "
          "fp32); paper technique covers 100% of GEMM FLOPs; runs long_500k",
)
