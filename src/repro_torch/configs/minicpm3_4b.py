"""openbmb/MiniCPM3-4B [hf]: 62L d=2560 40H d_ff=6400 vocab=73448,
multi-head latent attention (MLA): q_rank 768, kv_rank 256,
nope 64 / rope 32 / v 64 per head."""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv=40, d_ff=6400, vocab=73448,
    head_dim=64,
    mla=MLAConfig(q_rank=768, kv_rank=256, nope_dim=64, rope_dim=32,
                  v_dim=64),
)
