"""xLSTM-1.3B [arXiv:2405.04517, unverified]: 48 blocks d=2048 4H,
vocab 50304, no FFN (d_ff=0); mLSTM:sLSTM 7:1 interleave."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
    pattern=("mlstm", "mlstm", "mlstm", "mlstm",
             "mlstm", "mlstm", "mlstm", "slstm"),
    xlstm=XLSTMConfig(proj_factor=2.0, slstm_every=8, qk_dim_factor=0.5),
)
