"""meta-llama/Llama-4-Scout-17B-16E [unverified]: 48L d=5120 40H (GQA kv=8)
d_ff=8192, vocab 202048, MoE 16 routed experts top-1 + shared expert
(early-fusion multimodal; text backbone here per the assignment)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192, vocab=202048,
    head_dim=128, rope_theta=500000.0,
    moe=MoEConfig(num_experts=16, top_k=1, every=1, d_ff=8192,
                  shared_expert=True),
)
