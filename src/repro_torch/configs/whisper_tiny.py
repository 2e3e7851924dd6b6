"""Whisper-tiny: encoder-decoder, conv frontend stubbed to precomputed frame
embeddings. [arXiv:2212.04356; unverified] (``repro/configs/whisper_tiny.py``)"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-tiny",
    family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab=51865,
    layout="a", enc_layers=4, enc_seq=1500,
    norm="ln", activation="gelu", ffn_kind="mlp", use_rope=False,
    tie_embeddings=True,
    notes="MHA (kv=heads); learned decoder positions; sinusoidal encoder "
          "positions; frontend = input_specs() frame-embedding stub",
)
