"""ibm-granite/granite-3.0-1b-a400m-base [hf]: 24L d=1024 16H (GQA kv=8)
MoE 32 experts top-8, expert d_ff=512, vocab 49155."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv=8, d_ff=512, vocab=49155,
    head_dim=64, rope_theta=10000.0,
    moe=MoEConfig(num_experts=32, top_k=8, every=1, d_ff=512),
    tie_embeddings=True,
)
