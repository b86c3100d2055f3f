"""deepseek-ai/DeepSeek-V2-Lite [hf config.json]: 27L d=2048 16H, MLA
without query compression (kv_lora_rank 512, nope/rope/v 128/64/128),
YaRN rope (theta 1e4, factor 40 over 4,096 positions, beta 32/1, mscale
= mscale_all_dim = 0.707), RMSNorm eps 1e-6; layer 0 a dense SwiGLU of
10,944 (first_k_dense_replace 1), layers 1-26 MoE: 64 routed experts of
1,408, softmax top-6 greedy, gates not renormalised (norm_topk_prob
false, routed_scaling_factor 1), plus 2 shared experts (one SwiGLU of
2 x 1,408); vocab 102,400, untied."""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      YarnConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-lite", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv=16, d_ff=10944,
    vocab=102400, rope_theta=10000.0, norm_eps=1e-6,
    rope_scaling=YarnConfig(factor=40.0, original_max_position=4096,
                            beta_fast=32.0, beta_slow=1.0, mscale=0.707,
                            mscale_all_dim=0.707),
    first_dense=1,
    mla=MLAConfig(q_rank=None, kv_rank=512, nope_dim=128, rope_dim=64,
                  v_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, every=1, d_ff=1408,
                  shared_expert=True, capacity_factor=None,
                  shared_d_ff=2816, norm_topk=False),
)
