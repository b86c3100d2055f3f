"""OpenGVLab/InternVL2-1B [arXiv:2404.16821]: Qwen2-0.5B LM backbone:
24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151655. InternViT frontend is a
STUB per the assignment: input_specs() provides 256 precomputed patch
embeddings prepended to the token sequence."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv=2, d_ff=4864, vocab=151655,
    head_dim=64, qkv_bias=True, rope_theta=1000000.0,
    num_patches=256,
    tie_embeddings=True,
)
