"""openai/whisper-small [arXiv:2212.04356, unverified]: enc-dec,
12L encoder + 12L decoder, d=768 12H d_ff=3072 vocab=51865. The conv/mel
frontend is a STUB: input_specs() provides 1500 precomputed frame
embeddings as the encoder input."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, d_ff=3072, vocab=51865,
    head_dim=64,
    encoder_layers=12, encoder_frames=1500,
)
