"""google/gemma-2-27b [arXiv:2408.00118]: 46L d=4608 32H (GQA kv=16)
d_ff=36864, vocab 256000; alternating local(4096)/global attention,
attn logit softcap 50.0, final logit softcap 30.0."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv=16, d_ff=36864, vocab=256000,
    head_dim=128, attn_softcap=50.0, final_softcap=30.0,
    local_window=4096, local_global_alternate=True,
    pattern=("attn", "attn"),   # period 2: local, global
    tie_embeddings=True,
)
