"""ai21labs Jamba-1.5-Large [arXiv:2403.19887]: 72L d=8192 64H (GQA kv=8)
d_ff=24576, vocab 65536; hybrid Mamba:attention 7:1 interleave, MoE 16e
top-2 every other layer. 398B total / ~94B active."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv=8, d_ff=24576, vocab=65536,
    head_dim=128,
    # period-8 block: attention at position 0, Mamba at 1..7 (1:7 ratio)
    pattern=("attn", "mamba", "mamba", "mamba",
             "mamba", "mamba", "mamba", "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, every=2, d_ff=24576),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)
