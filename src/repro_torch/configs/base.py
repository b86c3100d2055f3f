"""Model / workload configuration system (the port's copy of
``repro/configs/base.py``, as data: no JAX, no ``repro``).

Every assigned architecture gets a ``repro_torch/configs/<id>.py`` exporting
``CONFIG`` (the exact published hyper-parameters) and the registry here maps
``--arch <id>`` to it. ``reduced()`` shrinks any config to a CPU-smoke-test
size while preserving its family-specific structure (MoE, MLA, hybrid
pattern, ...).

``ARCH_IDS`` are the reference's ten, the dry run's cells. The port serves
more (``SERVED_ARCH_IDS``: DeepSeek-V2-Lite), and their settings need keys
the reference has not: YaRN rope scaling (``ModelConfig.rope_scaling``),
leading dense layers (``first_dense``), MLA without query compression
(``MLAConfig.q_rank=None``), a shared expert of its own width
(``MoEConfig.shared_d_ff``), unrenormalised gates (``norm_topk=False``) and
dropless routing (``capacity_factor=None``). Each defaults to the
reference's behaviour, so the ten configs are unchanged.

Shapes: each arch is paired with the assigned LM shape set. ``train_*``
lowers ``train_step``; ``decode_*``/``long_*`` lower ``serve_step`` (one new
token against a seq_len KV cache); ``prefill_*`` lowers ``prefill_step``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    every: int = 1            # MoE at layer l iff l % every == every - 1
    d_ff: Optional[int] = None  # expert hidden (defaults to model d_ff)
    shared_expert: bool = False  # llama4-style always-on shared expert
    # None: dropless, every (token, expert) slot computed (sort-by-expert
    # dispatch, models/moe.py); else GShard's per-group capacity
    capacity_factor: Optional[float] = 1.25
    # the shared expert's SwiGLU width (DeepSeek's n_shared_experts x
    # moe_intermediate_size); None: one expert's width
    shared_d_ff: Optional[int] = None
    # renormalise the top-k gates to sum to one (False: the softmax
    # probabilities as they are, DeepSeek-V2's norm_topk_prob=false)
    norm_topk: bool = True

    @property
    def dropless(self) -> bool:
        return self.capacity_factor is None


@dataclasses.dataclass(frozen=True)
class YarnConfig:
    """YaRN rope scaling (Peng et al. 2023, as DeepSeek-V2 configures it):
    the inverse frequencies blend the original and the ``factor``-times
    slower ones by a linear ramp between the correction dimensions of
    ``beta_fast`` and ``beta_slow`` rotations over
    ``original_max_position`` positions; ``mscale`` and
    ``mscale_all_dim`` give the cos/sin factor and, squared, the
    softmax-scale factor of the attention that uses it."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_rank: Optional[int] = 768   # None: no query compression (q = x W_q)
    kv_rank: int = 256
    nope_dim: int = 64
    rope_dim: int = 32
    v_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None   # defaults to ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0
    slstm_every: int = 8            # position 7 in each 8-block is sLSTM
    qk_dim_factor: float = 0.5      # mLSTM qk head dim = v head dim * factor


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    # attention variants
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    final_softcap: Optional[float] = None   # gemma2: 30.0
    local_window: Optional[int] = None      # gemma2: 4096, alternating
    local_global_alternate: bool = False
    rope_theta: float = 10000.0
    rope_scaling: Optional[YarnConfig] = None
    # layers 0 .. first_dense - 1: attention blocks with a dense SwiGLU of
    # d_ff, held outside the period stack (DeepSeek's first_k_dense_replace);
    # the pattern and the MoE layers cover the n_layers - first_dense after
    first_dense: int = 0
    # block pattern: period-P list of layer kinds ("attn" | "mamba" |
    # "mlstm" | "slstm"); None => all "attn"
    pattern: Optional[Tuple[str, ...]] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # multimodality (stub frontends per the assignment)
    num_patches: int = 0            # vlm: patch embeddings prepended
    encoder_layers: int = 0         # enc-dec (whisper): encoder depth
    encoder_frames: int = 0         # whisper: precomputed frame count
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 so the embedding /
        unembedding shard evenly on any mesh axis up to 256 (standard
        Megatron/MaxText practice). Logits for padding rows are masked to
        -inf; labels never reference them."""
        return -(-self.vocab // 256) * 256

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        return self.pattern or ("attn",)

    def is_moe_layer(self, layer_idx: int) -> bool:
        """Whether pattern position ``layer_idx`` of the period stack (the
        layers after the ``first_dense`` leading ones) is an MoE layer."""
        return (self.moe is not None
                and layer_idx % self.moe.every == self.moe.every - 1)

    @property
    def stacked_layers(self) -> int:
        """The layers of the period stack: all but the leading dense ones."""
        return self.n_layers - self.first_dense

    @property
    def supports_long_context(self) -> bool:
        """True if decode state is sub-quadratic in seq (SSM/hybrid)."""
        kinds = set(self.layer_pattern)
        return bool(kinds & {"mamba", "mlstm", "slstm"})

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def reduced(self) -> "ModelConfig":
        """CPU-smoke-test size preserving family structure."""
        period = len(self.layer_pattern)
        moe = None
        if self.moe:
            moe = dataclasses.replace(self.moe, num_experts=4,
                                      top_k=min(self.moe.top_k, 2),
                                      d_ff=32 if self.moe.d_ff else None)
            if self.moe.shared_d_ff:    # keep its ratio to an expert's
                expert = self.moe.d_ff or self.d_ff
                moe = dataclasses.replace(moe, shared_d_ff=(
                    (moe.d_ff or 128) * self.moe.shared_d_ff // expert))
        mla = (dataclasses.replace(self.mla,
                                   q_rank=24 if self.mla.q_rank else None,
                                   kv_rank=16, nope_dim=8, rope_dim=4,
                                   v_dim=8)
               if self.mla else None)
        return dataclasses.replace(
            self,
            n_layers=self.first_dense + max(2, 2 * period),
            d_model=64,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=512,
            moe=moe,
            mla=mla,
            local_window=8 if self.local_window else None,
            num_patches=4 if self.num_patches else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_frames=8 if self.encoder_frames else 0,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS: List[str] = [
    "granite_moe_1b_a400m",
    "llama4_scout_17b_a16e",
    "jamba_1_5_large_398b",
    "qwen2_1_5b",
    "qwen3_0_6b",
    "gemma2_27b",
    "minicpm3_4b",
    "xlstm_1_3b",
    "internvl2_1b",
    "whisper_small",
]


#: configurations the port serves beyond the reference's ten (no dry-run
#: cells: the mesh path does not take them)
SERVED_ARCH_IDS: List[str] = ["deepseek_v2_lite"]


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS + SERVED_ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: "
                         f"{ARCH_IDS + SERVED_ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def shape_cells(arch: str) -> List[str]:
    """The dry-run cells for an arch, applying the DESIGN.md shape skips."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        cells.append("long_500k")
    return cells
