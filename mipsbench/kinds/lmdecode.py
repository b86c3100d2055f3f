"""LM decode behind the RANGE-LSH vocabulary head: a batch of sequences
prefilled once in set-up, then stepped one position at a time through
``BatchedServer.step``, whose fused LSH head returns each sequence's top-k
tokens. One call is one step of the whole batch; one query is one
sequence's next-token lookup.

The configuration names the model by its source's keys (a DeepSeek-V2
``config.json``); :func:`model_config` maps them onto the program's
``ModelConfig``. Weights, the head's projections and its calibration
prompts come from the configuration's ``data_seed`` (one deployment,
calibrated once, as a server calibrates its head offline), the served
prompts from the run's seed.

Set-up: a server with the exact head prefills the calibration prompts,
keeping the final hidden states of each one's last positions
(``calib_prefill_s``), and the batch into caches of ``max_seq`` slots
(``prefill_s``); the head index is built over the unembedding,
calibrated on those states (``calibrate_s``) and given its bucket store
(``bucket_store_s``), ``repeats`` times together (``build_s`` their
mean, the steps' means beside it), after one untimed build that
compiles the kernels; then the serving server mounts the calibrated head
and its store, plans ``num_probe`` for the recall target, and the head's
top token of each prompt's last state is the first token fed. The
servers keep no state between calls: the caches pass from the one to the
other. On the card the serving server replays the model's step as a CUDA
graph (``lm.decode_capturable``), captured at the first call (slot 0, in
set-up), tracked or not.

Call ``slot``: one step at position ``prompt + slot``, fed the last
step's top token (at slot 0 the first token again: the prompt's cache
rows are never rewritten). The step's final hidden state and the fed
tokens are kept by slot for the judge.

Judge: the plain reference (``reference/deepseek_v2_lite.py``, float32)
runs the full forward of a few sampled sequences over the prompt and the
tokens fed, and the program's final hidden states and their logits are
held to it at every position served (``hidden_gap``, ``logit_gap``); every
returned value is held to the exact float64 inner product of the
program's hidden state with that token's row (``score_gap``, over the
query's best logit); ``recall_at_10`` is the head's ids against the exact
top-k of the program's own hidden state.

Traced runs: the harness sets ``traced.tracker`` for the span phase; the
server hands it to the fused head's engine, and the graph's layer spans
come timed on the device. On detach the program writes the steps' least
work into its ``timings`` (the per-layer readers read it there):
``attn_bytes`` (every layer's attention weights and the live latent
cache, a step), ``step_bytes`` (those, the dense and shared weights, the
routers, every expert the routing counter says a layer touched, and the
head's payload) and ``step_flops`` (the model's matrix products), with
the routing counters beside them. The calls after the detach, untracked,
are the profiled phase's: ``profiled_steps`` counts them less the one
the profiler discards as its warm-up (``devtrace.profile_batches``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple

import numpy as np
import torch

from mipsbench.reference import deepseek_v2_lite as ref

COMPARED = ("logit_gap", "hidden_gap", "score_gap")
INVALID = 1e9
SUPPORTED = {"scoring_func": "softmax", "topk_method": "greedy",
             "hidden_act": "silu", "n_group": 1, "topk_group": 1,
             "routed_scaling_factor": 1, "attention_bias": False,
             "moe_layer_freq": 1}


def model_config(config: dict):
    """The program's ``ModelConfig`` for a DeepSeek-V2 configuration given
    by its source's keys; a setting the program does not serve raises."""
    from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                          YarnConfig)

    for key, want in SUPPORTED.items():
        if config[key] != want:
            raise ValueError(f"{key}={config[key]!r}: the program serves "
                             f"{want!r} only")
    ys = config["rope_scaling"]
    if ys["type"] != "yarn":
        raise ValueError(f"rope_scaling type {ys['type']!r}: yarn only")
    expert = int(config["moe_intermediate_size"])
    shared = int(config["n_shared_experts"])
    return ModelConfig(
        name=config["name"], family="moe",
        n_layers=int(config["num_hidden_layers"]),
        d_model=int(config["hidden_size"]),
        n_heads=int(config["num_attention_heads"]),
        n_kv=int(config["num_key_value_heads"]),
        d_ff=int(config["intermediate_size"]),
        vocab=int(config["vocab_size"]),
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        rope_scaling=YarnConfig(
            factor=float(ys["factor"]),
            original_max_position=int(ys["original_max_position_embeddings"]),
            beta_fast=float(ys["beta_fast"]),
            beta_slow=float(ys["beta_slow"]), mscale=float(ys["mscale"]),
            mscale_all_dim=float(ys["mscale_all_dim"])),
        first_dense=int(config["first_k_dense_replace"]),
        mla=MLAConfig(q_rank=config["q_lora_rank"],
                      kv_rank=int(config["kv_lora_rank"]),
                      nope_dim=int(config["qk_nope_head_dim"]),
                      rope_dim=int(config["qk_rope_head_dim"]),
                      v_dim=int(config["v_head_dim"])),
        moe=MoEConfig(num_experts=int(config["n_routed_experts"]),
                      top_k=int(config["num_experts_per_tok"]), every=1,
                      d_ff=expert, shared_expert=shared > 0,
                      capacity_factor=None, shared_d_ff=shared * expert,
                      norm_topk=bool(config["norm_topk_prob"])),
        tie_embeddings=bool(config["tie_word_embeddings"]),
    )


class Inputs(NamedTuple):
    cfg: object              # the program's ModelConfig
    params: dict             # the bf16 weight tree
    prompts: torch.Tensor    # (B, S0) int64
    calibration: torch.Tensor  # (C, S0) int64, the head's calibration
    slots: int
    k: int


def make_inputs(config: dict, mix: dict, seed: int,
                device: torch.device) -> Inputs:
    """The weights and the calibration prompts from the configuration's
    ``data_seed``, the served prompts (uniform token ids) from ``seed``,
    all drawn on ``device``."""
    from repro_torch.models import lm

    cfg = model_config(config)
    data_seed = int(config["data_seed"])
    params = lm.init_params(torch.Generator(device=device).manual_seed(
        data_seed), cfg, device=device)
    S0 = int(mix["prompt_tokens"])

    def tokens(seed_, rows):
        gen = torch.Generator(device=device).manual_seed(seed_)
        return torch.randint(0, cfg.vocab, (rows, S0), generator=gen,
                             device=device)

    return Inputs(cfg, params, tokens(int(seed), int(mix["batch"])),
                  tokens(data_seed + 2,
                         int(config["head"]["calibration_prompts"])),
                  int(mix["slots"]), int(config["head"]["k"]))


def _numel_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    return tree.numel()


def step_work(cfg, params: dict, batch: int, live: float, touched: float,
              head_rows: int) -> Dict[str, float]:
    """Least work of one decode step of ``batch`` sequences whose caches
    hold ``live`` positions: ``attn_bytes`` (every layer's attention
    weights once, the live latent and rope-key cache), ``step_bytes``
    (those, every other weight a step needs once: norms, the dense FFNs,
    routers and shared experts, ``touched`` experts' weights over all
    layers; the batch's embedding rows; ``head_rows`` float32 rows of the
    head's payload) and ``step_flops`` (2 a multiply-add of the model's
    products: every attention weight, the latent scores and weighted sum
    over ``live`` positions, the dense FFNs, routers and shared experts,
    and ``top_k`` experts a token)."""
    m, moe = cfg.mla, cfg.moe
    stacks = [params["pos0"]] + ([params["lead"]] if cfg.first_dense
                                 else [])
    mixers = sum(_numel_bytes(s["mixer"]) for s in stacks)
    mixer_params = sum(_numel(s["mixer"]) for s in stacks)
    cache_row = (m.kv_rank + m.rope_dim) * 2            # bf16 latent + key
    cache = batch * live * cache_row * cfg.n_layers
    experts = params["pos0"]["ffn"]
    expert_bytes = sum(experts[n][0, 0].numel() * experts[n].element_size()
                       for n in ("w_gate", "w_up", "w_down"))
    expert_params = sum(experts[n][0, 0].numel()
                        for n in ("w_gate", "w_up", "w_down"))
    routed = ("w_gate", "w_up", "w_down")
    other = {n: t for n, t in experts.items() if n not in routed}
    lead_ffn = params["lead"]["ffn"] if cfg.first_dense else {}
    norms = sum(_numel_bytes(s[n]) for s in stacks
                for n in ("norm1", "norm2")) + _numel_bytes(
                    params["final_norm"])
    dense_bytes = _numel_bytes(other) + _numel_bytes(lead_ffn) + norms
    embed_rows = batch * cfg.d_model * params["embed"].element_size()
    attn_bytes = mixers + cache
    per_token = (2 * (mixer_params + _numel(other) + _numel(lead_ffn))
                 + 2 * moe.top_k * expert_params * (cfg.n_layers
                                                    - cfg.first_dense)
                 + 2 * cfg.n_heads * live * (2 * m.kv_rank + m.rope_dim)
                 * cfg.n_layers)
    return {"attn_bytes": float(attn_bytes),
            "step_bytes": float(attn_bytes + dense_bytes + embed_rows
                                + touched * expert_bytes
                                + head_rows * cfg.d_model * 4),
            "step_flops": float(batch * per_token)}


class _Traced:
    """What the harness hands a tracker for the span phase: the serving
    server's. Detached, it writes the tracked steps' least work and
    routing counters into the program's ``timings``."""

    def __init__(self, prog: "Program"):
        self._prog = prog
        self.live: List[int] = []
        self.detached = False

    @property
    def tracker(self):
        return self._prog.server.tracker

    @tracker.setter
    def tracker(self, tracker) -> None:
        before = self._prog.server.tracker
        self._prog.server.tracker = tracker
        if tracker is None and before is not None and self.live:
            self._prog.note_work(before, self.live)
            self.detached = True
            self._prog.timings["profiled_steps"] = -1.0


class Program:
    """The serving server, the batch's caches, and per slot the fed
    tokens and the step's final hidden state."""

    def __init__(self, server, caches, first: torch.Tensor, inputs: Inputs,
                 timings: Dict[str, float]):
        B, S0 = inputs.prompts.shape
        self.server, self.caches, self.first = server, caches, first
        self.cfg, self.params, self.prompt = inputs.cfg, inputs.params, S0
        self.k, self.timings = inputs.k, timings
        self.tok = first
        self.fed = torch.empty((inputs.slots, B), dtype=torch.int64,
                               device=first.device)
        self.hidden = torch.empty((inputs.slots, B, inputs.cfg.d_model),
                                  dtype=inputs.params["embed"].dtype,
                                  device=first.device)
        self.traced = _Traced(self)

    def note_work(self, tracker, live: List[int]) -> None:
        steps = len(live)
        counters = tracker.counters
        touched = counters.get("repro.model.moe.touched_experts", 0.0) / steps
        work = step_work(self.cfg, self.params, self.fed.shape[1],
                         float(np.mean(live)), touched,
                         int(self.server.num_probe))
        self.timings.update(work)
        for name in ("routed_tokens", "dropped_tokens", "touched_experts"):
            self.timings[f"moe_{name}"] = counters.get(
                f"repro.model.moe.{name}", 0.0) / steps
        self.timings["moe_max_expert_tokens"] = tracker.gauges.get(
            "repro.model.moe.max_expert_tokens", 0.0)
        self.timings["traced_steps"] = float(steps)


def set_up(config: dict, inputs: Inputs, device: torch.device,
           sync: Callable, repeats: int = 1) -> Program:
    from repro_torch.core.bucket_index import build_bucket_index
    from repro_torch.launch import serve
    from repro_torch.models import lm, lm_head

    head = config["head"]
    cfg, params = inputs.cfg, inputs.params
    B, S0 = inputs.prompts.shape
    max_seq = S0 + inputs.slots
    tail = int(head["calibration_states"]) // inputs.calibration.shape[0]
    t_cal = time.perf_counter()
    plain = serve.BatchedServer(cfg, params, max_seq=max_seq, batch=B,
                                device=device)
    calib_states, _ = plain.prefill(inputs.calibration, tail=tail)
    calib_states = calib_states.reshape(-1, cfg.d_model)
    sync()
    t0 = time.perf_counter()
    states, caches = plain.prefill(inputs.prompts)
    sync()
    t1 = time.perf_counter()
    unembed = lm._unembed_matrix(params, cfg)

    steps = dict.fromkeys(("index_s", "calibrate_s", "bucket_store_s"),
                          0.0)

    def build():
        gen = torch.Generator(device=device).manual_seed(
            int(config["data_seed"]) + 1)
        t = time.perf_counter()
        vidx = lm_head.build_vocab_index(
            unembed, gen, code_len=int(head["code_len"]),
            num_ranges=int(head["num_ranges"]))
        sync()
        t1 = time.perf_counter()
        calib = lm_head.calibrate_vocab_index(vidx, unembed, calib_states,
                                              k=inputs.k)
        sync()
        t2 = time.perf_counter()
        buckets = build_bucket_index(vidx)
        sync()
        t3 = time.perf_counter()
        for name, dt in zip(steps, (t1 - t, t2 - t1, t3 - t2)):
            steps[name] += dt
        return vidx._replace(calib=calib), buckets

    build()                     # the kernels compile here, off the clock
    steps.update(dict.fromkeys(steps, 0.0))
    t2 = time.perf_counter()
    for _ in range(repeats):
        built = None            # the last build's memory goes first
        built = build()
    t3 = time.perf_counter()
    vidx, buckets = built
    server = serve.BatchedServer(
        cfg, params, max_seq=max_seq, batch=B, lsh_decode=True,
        engine="fused", vocab_index=vidx, buckets=buckets,
        recall_target=float(head["recall_target"]), device=device)
    first = server.head_topk(states[:, -1], inputs.k)[1][:, 0]
    sync()
    t4 = time.perf_counter()
    return Program(server, caches, first, inputs,
                   {"calib_prefill_s": t0 - t_cal, "prefill_s": t1 - t0,
                    "warm_s": t2 - t1,
                    **{n: v / repeats for n, v in steps.items()},
                    "build_s": (t3 - t2) / repeats, "server_s": t4 - t3})


def caller(prog: Program, config: dict, mix: dict, inputs: Inputs):
    """(call(slot) -> (vals, ids) (B, k), slots)."""
    k, S0 = prog.k, prog.prompt

    def call(slot: int):
        if slot == 0:
            prog.tok = prog.first
        prog.fed[slot].copy_(prog.tok)
        if prog.server.tracker is not None:
            prog.traced.live.append(S0 + slot + 1)
        elif prog.traced.detached:
            prog.timings["profiled_steps"] += 1.0
        out = prog.server.step(prog.tok, prog.caches, S0 + slot, k)
        prog.hidden[slot].copy_(out.hidden)
        prog.tok = out.ids[:, 0]
        return out.vals, out.ids

    return call, inputs.slots


class Served(NamedTuple):
    slots: List[int]
    vals: torch.Tensor       # (steps, B, k)
    ids: torch.Tensor        # (steps, B, k)
    hidden: torch.Tensor     # (slots, B, d), by slot
    fed: torch.Tensor        # (slots, B), by slot
    num_probe: int
    counters: Dict[str, float]


def served(prog: Program, window) -> Served:
    counters = {n: v for n, v in prog.timings.items()
                if n.startswith("moe_")}
    return Served(list(window.slots), window.vals, window.ids, prog.hidden,
                  prog.fed, int(prog.server.num_probe), counters)


def _latest(slots: List[int]) -> Dict[int, int]:
    """Slot -> the window step that last served it (a wrapped window
    serves a slot again, with the buffers holding the last pass)."""
    return {s: i for i, s in enumerate(slots)}


def _rel(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """‖got − want‖₂ / ‖want‖₂ along the last dimension."""
    return (torch.linalg.vector_norm(got - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1))


def judge(served: Served, inputs: Inputs, cell, seed: int):
    """(judged, recall_at_10, lines): the reference's verdict on the
    sampled sequences, every answer's values against exact inner
    products, and the head's recall against the exact top-k."""
    cfg, k = inputs.cfg, inputs.k
    limits = cell.workload["limits"]
    V = cfg.vocab
    last = _latest(served.slots)
    used = sorted(last)
    step_of = torch.as_tensor([last[s] for s in used],
                              device=served.ids.device)
    ids = served.ids[step_of].long()                    # (n, B, k)
    vals = served.vals[step_of].double()
    hidden = served.hidden[used].float()                # (n, B, d)
    unembed = inputs.params["unembed"][:, :V].float()
    n, B, _ = ids.shape

    hits, best, exact = [], [], []
    with ref.no_tf32():
        for i in range(n):
            logits = hidden[i] @ unembed                  # (B, V)
            top = torch.topk(logits, k, dim=-1)
            hits.append((ids[i][..., :, None] == top.indices[..., None, :])
                        .any(-1).float().mean())
            best.append(top.values[:, 0].double())
            valid = (ids[i] >= 0) & (ids[i] < V)
            rows = unembed.T[ids[i].clamp(0, V - 1)].double()   # (B, k, d)
            exact.append(torch.where(valid, torch.einsum(
                "bkd,bd->bk", rows, hidden[i].double()), torch.nan))
    recall = float(torch.stack(hits).mean())
    best, exact = torch.stack(best), torch.stack(exact)
    gap = (vals - exact).abs() / best.abs()[..., None]
    repeated = (ids[..., :, None] == ids[..., None, :]).sum(-1) > 1
    bad = torch.isnan(exact) | repeated
    invalid = int(bad.sum())
    score_gap = INVALID if invalid else float(gap.max())

    rng = np.random.default_rng(seed)
    sample = sorted(rng.choice(B, size=min(int(
        cell.workload["sample_sequences"]), B), replace=False).tolist())
    top_slot = max(used)
    fed = served.fed[:top_slot + 1]
    at = torch.as_tensor([inputs.prompts.shape[1] + s for s in used],
                         device=ids.device)
    hidden_gap = logit_gap = 0.0
    for b in sample:
        tokens = torch.cat([inputs.prompts[b], fed[:, b]])
        h_ref, l_ref = ref.forward(inputs.params, tokens,
                                   cell.config, positions=at)
        with ref.no_tf32():
            l_prog = hidden[:, b] @ unembed
        hidden_gap = max(hidden_gap, float(_rel(hidden[:, b], h_ref).max()))
        logit_gap = max(logit_gap, float(_rel(l_prog, l_ref).max()))
        del h_ref, l_ref, l_prog
    values = {"logit_gap": logit_gap, "hidden_gap": hidden_gap,
              "score_gap": score_gap}
    checks = {name: {"value": values[name], "limit": limits[name]}
              for name in COMPARED}
    judged = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "invalid_answers": invalid, "checks": checks}
    counters = (", ".join(f"{n} {v!r}" for n, v in served.counters.items())
                or "not tracked in this run")
    lines = [f"head: num_probe {served.num_probe} of {V}; steps judged "
             f"{n} (slots 0-{top_slot}); sampled sequences {sample}, "
             f"{len(used)} positions each; invalid answers {invalid}",
             f"routing counters a traced step: {counters}"]
    return judged, recall, lines
