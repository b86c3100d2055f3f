"""Qwen/Qwen3-0.6B [hf:Qwen/Qwen3-8B family]: 28L d=1024 16H (GQA kv=8)
d_ff=3072, vocab 151936, qk_norm, head_dim 128."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv=8, d_ff=3072, vocab=151936,
    head_dim=128, qk_norm=True, rope_theta=1000000.0,
    tie_embeddings=True,
)
