"""The LM decode kind (``kinds/lmdecode.py``) on the CPU at a tiny size:
the cell's configuration maps onto the program's DeepSeek-V2-Lite config,
a run through ``run_cell`` is judged correct with its end-to-end and
per-layer metrics, the program with the softmax's mscale left out and the
weights rounded through float8 (the control of ``controls_lmdecode.py``)
are judged wrong, and the least work the readers use counts the published
sizes."""

import json
from pathlib import Path

import pytest
import torch

from mipsbench import controls_lmdecode, harness
from mipsbench.kinds import lmdecode

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "dsv2lite-decode-b64-ctx8k"
SEED = 2 ** 31 + 29
TINY = {"config": {"hidden_size": 64, "num_attention_heads": 4,
                   "num_key_value_heads": 4, "kv_lora_rank": 16,
                   "qk_nope_head_dim": 8, "qk_rope_head_dim": 4,
                   "v_head_dim": 8, "intermediate_size": 128,
                   "moe_intermediate_size": 32, "n_routed_experts": 8,
                   "num_experts_per_tok": 3, "num_hidden_layers": 3,
                   "vocab_size": 512,
                   "head": {"family": "simple", "code_len": 64,
                            "num_ranges": 8, "engine": "fused",
                            "recall_target": 0.9, "calibration_states": 8,
                            "calibration_prompts": 2, "k": 10}},
        "mix": {"batch": 4, "prompt_tokens": 24, "slots": 8},
        "workload": {"build_repeats": 1, "sample_sequences": 2}}


def _run(trace: bool):
    return harness.run_cell(MANIFEST, CELL, SEED, 0.3, trace, device="cpu",
                            overrides=TINY)


def test_configuration_is_the_registered_config():
    from repro_torch.configs.base import get_config
    cell = harness.resolve_cell(MANIFEST, CELL)
    assert lmdecode.model_config(cell.config) == get_config(
        "deepseek_v2_lite")
    assert cell.config["reduced"] == []
    with pytest.raises(ValueError, match="topk_method"):
        lmdecode.model_config({**cell.config, "topk_method": "group_limited"})


def test_tiny_cell_is_correct_untraced_and_traced():
    result, lines = _run(False)
    assert result["correct"] and result["failed"] == 0
    assert set(result["metrics"]) == {"queries_per_s", "batch_ms_p95",
                                      "recall_at_10", "build_s", "setup_s"}
    assert result["attempted"] % TINY["mix"]["batch"] == 0
    assert list(result["checks"]) == list(lmdecode.COMPARED)
    assert any(line.startswith("head: num_probe") for line in lines)
    result, lines = _run(True)
    assert result["correct"]
    # no card: the device trace, and the shares over the card's peaks,
    # are not read; the server hands the tracker to the head's engine
    assert {"latent_attn_ms", "moe_ms", "vocab_head_ms", "prefill_s",
            "encode_ms", "directory_ms", "directory_scan_ms",
            "rank_sort_ms", "probe_score_ms", "runs_ms", "fused_score_ms",
            "calibrate_s", "bucket_store_s"} <= set(result["metrics"])
    counters = next(line for line in lines if line.startswith("routing"))
    assert "moe_dropped_tokens 0.0" in counters


def test_mscale_left_out_is_judged_wrong(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "yarn_softmax_factor", lambda ys: 1.0)
    result, _ = _run(False)
    assert not result["correct"]
    checks = result["checks"]
    assert checks["hidden_gap"]["value"] > checks["hidden_gap"]["limit"]


def test_float8_weights_control_is_judged_wrong():
    cell = harness.resolve_cell(MANIFEST, CELL, TINY)
    row = controls_lmdecode.read(cell, 3, 4, torch.device("cpu"), True)
    assert not row["correct"]
    assert row["hidden_gap"] > cell.workload["limits"]["hidden_gap"]


def test_least_work_counts_the_published_sizes():
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    cfg = get_config("deepseek_v2_lite")
    params = lm.init_params(None, cfg, device="meta")
    live = 8700
    work = lmdecode.step_work(cfg, params, 64, live, 64 * 26, 50000)
    cache = 64 * live * (512 + 64) * 2 * 27
    mixer = 27 * (2 * (2048 * 3072 + 2048 * 512 + 2048 * 64
                       + 2 * 512 * 2048 + 2048 * 2048) + 4 * 512)
    assert work["attn_bytes"] == cache + mixer
    experts = 64 * 26 * 3 * 2048 * 1408 * 2
    assert work["step_bytes"] > work["attn_bytes"] + experts + 50000 * 2048 * 4
    assert work["step_bytes"] < 1.02 * (work["attn_bytes"] + experts
                                        + 50000 * 2048 * 4 + 26 * 3 * 2048
                                        * 2816 * 2 + 3 * 2048 * 10944 * 2
                                        + 26 * 2048 * 64 * 4)
    per_token_attn = 27 * 2 * 16 * live * (2 * 512 + 64)
    assert work["step_flops"] > 64 * per_token_attn
