"""``ops.latent_attend``, MLA's absorbed decode attention as one op: its
plain version against the arithmetic ``models/attention.py`` ran before the
op (two f32 einsums, the mask, the softmax), bit for bit, at
DeepSeek-V2-Lite's and MiniCPM3's widths; ``mla_decode`` through the op
against the same decode through that arithmetic; the validation that
runs before any dispatch; the kernel's launch plan as the host sizes it.
The kernel itself runs on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import attention
from repro_torch.obs import Tracker
from repro_torch.obs.cost import latent_attend_cost

# (kv_rank, rope_dim, heads): DeepSeek-V2-Lite's and MiniCPM3's
WIDTHS = [(512, 64, 16), (256, 32, 40)]
B, S = 2, 70


def _before(q_lat, q_rope, c_kv, k_rope, cache_pos, scale):
    """The absorbed attention as ``mla_decode`` computed it before the op
    (``_mla_scores`` then ``_mla_attend``, offset 0)."""
    f32 = torch.float32
    s = (torch.einsum("bhr,bsr->bhs", q_lat, c_kv.to(f32))
         + torch.einsum("bhn,bsn->bhs", q_rope.to(f32), k_rope.to(f32)))
    s = s * scale
    keep = torch.arange(c_kv.shape[1]) <= cache_pos
    pattn = torch.softmax(torch.where(keep, s, attention.NEG_INF), dim=-1)
    return torch.einsum("bhs,bsr->bhr", pattn, c_kv.to(f32))


def _inputs(r, rho, h, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, h, r), generator=g),
            torch.randn((B, h, rho), generator=g).to(dtype),
            torch.randn((B, S, r), generator=g).to(dtype),
            torch.randn((B, S, rho), generator=g).to(dtype))


@pytest.mark.parametrize("r,rho,h", WIDTHS)
@pytest.mark.parametrize("at", [0, S // 2, S - 1])
@pytest.mark.parametrize("form", ["0-d", "(1,)"])
def test_plain_version_equals_the_absorbed_attention_before(r, rho, h, at,
                                                            form):
    q_lat, q_rope, c_kv, k_rope = _inputs(r, rho, h)
    pos = torch.tensor(at) if form == "0-d" else torch.tensor([at])
    got = ops.latent_attend(q_lat, q_rope, c_kv, k_rope, pos, 0.0625,
                            impl="ref")
    assert got.dtype == torch.float32 and got.shape == (B, h, r)
    assert torch.equal(got, _before(q_lat, q_rope, c_kv, k_rope, at,
                                    0.0625))
    # auto on CPU tensors is the plain version, and launches nothing
    ops.reset_launch_counts()
    assert torch.equal(ops.latent_attend(q_lat, q_rope, c_kv, k_rope, pos,
                                         0.0625), got)
    assert ops.launch_counts["latent_attend"] == 0


def test_slots_past_the_position_do_not_count():
    q_lat, q_rope, c_kv, k_rope = _inputs(512, 64, 16)
    pos = torch.tensor([40])
    want = ops.latent_attend(q_lat, q_rope, c_kv, k_rope, pos, 0.1)
    c_kv[:, 41:], k_rope[:, 41:] = 1e4, -1e4
    assert torch.equal(ops.latent_attend(q_lat, q_rope, c_kv, k_rope, pos,
                                         0.1), want)


def _kernel_model(q_lat, q_rope, c_kv, k_rope, at, scale, splits, lo=True):
    """``latent_attn.cu``'s arithmetic in plain torch: the live slots in
    tiles of 64, each split's share of the tiles under an online softmax
    in f32, q_lat, q_rope and P as hi + lo bf16 pairs (hi alone with
    ``lo`` False: the single rounding), the splits merged by their
    log-sum-exp."""
    f32, tile, n = torch.float32, 64, at + 1

    def parts(x):
        hi = x.to(torch.bfloat16).to(f32)
        return (hi, (x - hi).to(torch.bfloat16).to(f32)) if lo else (hi,)
    qs, rs = parts(q_lat), parts(q_rope.to(f32))
    c, k = c_kv.to(f32), k_rope.to(f32)
    tiles = -(-n // tile)
    per = -(-tiles // splits)
    shares = []
    for j in range(splits):
        if j * per >= tiles:
            continue
        m = torch.full(q_lat.shape[:2], float("-inf"))
        l = torch.zeros(q_lat.shape[:2])
        o = torch.zeros(q_lat.shape)
        for t in range(j * per, min(tiles, (j + 1) * per)):
            live = slice(t * tile, min(n, (t + 1) * tile))
            ct, kt = c[:, live], k[:, live]
            s = scale * (sum(torch.einsum("bhr,bsr->bhs", q, ct) for q in qs)
                         + sum(torch.einsum("bhn,bsn->bhs", q, kt)
                               for q in rs))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            a = torch.exp(m - m_new)
            l = l * a + p.sum(-1)
            o = o * a[..., None] + sum(torch.einsum("bhs,bsr->bhr", q, ct)
                                       for q in parts(p))
            m = m_new
        shares.append((m, l, o))
    top = torch.stack([m for m, _, _ in shares]).amax(0)
    w = [torch.exp(m - top) for m, _, _ in shares]
    return (sum(wi[..., None] * o for wi, (_, _, o) in zip(w, shares))
            / sum(wi * l for wi, (_, l, _) in zip(w, shares))[..., None])


@pytest.mark.parametrize("r,rho,h", WIDTHS)
@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_the_kernels_split_tiles_and_hi_lo_operands_meet_the_plain_version(
        r, rho, h, splits):
    """The design's correctness argument, on the CPU: tiles, online
    softmax, hi + lo operands and the merge land within the card tests'
    tolerance of the plain version (5e-5 of a row's norm), at a ragged
    tail and with splits that get no tile; one rounding misses it by far
    more than 10x."""
    q_lat, q_rope, c_kv, k_rope = _inputs(r, rho, h, seed=splits)
    want = ref.latent_attend_ref(q_lat, q_rope, c_kv, k_rope, S - 3, 0.1)

    def err(got):
        return float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
    assert err(_kernel_model(q_lat, q_rope, c_kv, k_rope, S - 3, 0.1,
                             splits)) <= 5e-5
    assert err(_kernel_model(q_lat, q_rope, c_kv, k_rope, S - 3, 0.1,
                             splits, lo=False)) >= 10 * 5e-5


def _mla_cfg(arch, widths):
    """``arch`` at ``reduced()`` size, its MLA at ``widths`` (kv_rank,
    rope_dim, heads) where given."""
    cfg = get_config(arch).reduced()
    if widths is None:
        return cfg
    r, rho, h = widths
    return dataclasses.replace(cfg, n_heads=h, mla=dataclasses.replace(
        cfg.mla, kv_rank=r, rope_dim=rho))


@pytest.mark.parametrize("arch,widths", [
    ("deepseek_v2_lite", None), ("minicpm3_4b", None),
    ("deepseek_v2_lite", WIDTHS[0]), ("minicpm3_4b", WIDTHS[1])])
@pytest.mark.parametrize("host_pos", [True, False])
def test_mla_decode_returns_what_it_returned_before(arch, widths, host_pos,
                                                    monkeypatch):
    """The decode through the op, and through the arithmetic it replaced
    (patched in where the op is called): the same output and cache bit
    for bit, at a host position and at a 0-d tensor's."""
    cfg = _mla_cfg(arch, widths)
    m = cfg.mla
    g = torch.Generator().manual_seed(3)
    p = attention.attn_init(g, cfg)
    x = torch.randn((B, cfg.d_model), generator=g).to(p["w_o"].dtype)
    cache = attention.AttnCache(
        torch.randn((B, 24, m.kv_rank), generator=g).to(torch.bfloat16),
        torch.randn((B, 24, m.rope_dim), generator=g).to(torch.bfloat16))
    at = 17
    pos = at if host_pos else torch.tensor(at)

    def run():
        c = attention.AttnCache(*(t.clone() for t in cache))
        return attention.mla_decode(p, x, c, pos, cfg)

    out, new = run()
    with monkeypatch.context() as mp:
        mp.setattr(ops, "latent_attend",
                   lambda ql, qr, ck, kr, _pos, scale, **_: _before(
                       ql, qr, ck, kr, at, scale))
        want, want_cache = run()
    assert torch.equal(out, want)
    for a, b in zip(new, want_cache):
        assert torch.equal(a, b)


def _bad_inputs():
    q_lat, q_rope, c_kv, k_rope = _inputs(512, 64, 16)
    pos = torch.tensor([3])
    ok = (q_lat, q_rope, c_kv, k_rope, pos, 0.1)

    def but(i, v, impl="auto"):
        args = list(ok)
        args[i] = v
        return args, impl
    f32 = dict(zip(("q", "qr", "c", "k"),
                   _inputs(512, 64, 16, torch.float32)))
    small = _inputs(128, 64, 16)
    return {
        "q_lat_bf16": but(0, q_lat.to(torch.bfloat16)),
        "q_lat_2d": but(0, q_lat[0]),
        "q_rope_heads": but(1, q_rope[:, :8]),
        "c_kv_rank": but(2, c_kv[..., :256]),
        "k_rope_slots": but(3, k_rope[:, :10]),
        "k_rope_int": but(3, k_rope.to(torch.int32)),
        "pos_int32": but(4, pos.to(torch.int32)),
        "pos_two": but(4, torch.tensor([3, 4])),
        "pos_float": but(4, torch.tensor(3.0)),
        "empty_cache": (list(ok[:2]) + [c_kv[:, :0], k_rope[:, :0]]
                        + list(ok[4:]), "auto"),
        "kernel_f32_cache": ([f32["q"], f32["qr"], f32["c"], f32["k"], pos,
                              0.1], "cuda"),
        "kernel_other_rank": (list(small) + [pos, 0.1], "cuda"),
        "kernel_too_many_heads": (list(_inputs(512, 64, 17)) + [pos, 0.1],
                                  "cuda"),
        "kernel_strided_cache": but(2, torch.zeros((B, S, 514),
                                                   dtype=torch.bfloat16
                                                   )[..., :512], "cuda"),
        "unknown_impl": but(5, 0.1, "pallas"),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_bad_inputs_raise_before_any_dispatch(case):
    args, impl = _bad_inputs()[case]
    tr = Tracker()
    ops.set_dispatch_tracker(tr)
    try:
        with pytest.raises(ValueError):
            ops.latent_attend(*args, impl=impl)
    finally:
        ops.set_dispatch_tracker(None)
    assert not any("latent_attend" in k for k in tr.counters)


def test_kernel_fits_bf16_caches_at_its_widths_only():
    """The kernel's own refusal, which runs before the device check: a
    cache it takes gets as far as asking for the card (these are CPU
    tensors), any other is refused for its dtype or widths."""
    pos = torch.tensor([3])

    def refusal(q_lat, q_rope, c_kv, k_rope):
        with pytest.raises(ValueError) as e:
            ops.latent_attend(q_lat, q_rope, c_kv, k_rope, pos, 0.1,
                              impl="cuda")
        return "kernel takes" in str(e.value)
    for r, rho, h in WIDTHS:
        q_lat, q_rope, c_kv, k_rope = _inputs(r, rho, h)
        assert not refusal(q_lat, q_rope, c_kv, k_rope)
        assert not refusal(q_lat[:, :1], q_rope[:, :1], c_kv, k_rope)
        assert refusal(*_inputs(r, rho, 49))
        assert refusal(q_lat, q_rope, c_kv.float(), k_rope.float())
    assert refusal(*_inputs(16, 4, 4))                # reduced() widths
    assert refusal(*_inputs(512, 64, 17))


def test_launch_plan_as_the_host_sizes_it():
    assert ops.launch_shape_class(
        "latent_attend", (64, 16, 9216, 512, 64, 2)) == (
        "latent_attend", {"b": 64, "h": 16, "s": 9216, "r": 512, "rho": 64,
                          "splits": 2})
    # one wave of one block an SM
    assert ops.latent_attend_splits(64, 132) == 2
    assert ops.latent_attend_splits(8, 132) == 16
    assert ops.latent_attend_splits(200, 132) == 1


def test_cost_counts_every_slot_the_launch_may_read():
    c = latent_attend_cost(64, 16, 9216, 512, 64)
    assert c["flops"] == 2.0 * 64 * 16 * 9216 * (512 + 512 + 64)
    assert c["hbm_bytes"] == (2 * 64 * 9216 * 576 + 4 * 64 * 16 * 1088 + 8)
    assert latent_attend_cost(1, 1, 1, 1, 1, cache_bytes=4)["hbm_bytes"] == (
        4 * 2 + 4 * 3 + 8)


def test_multi_shard_scores_are_the_plain_versions():
    """The sequence-sharded path keeps the plain scores: a shard's slots at
    its offset, masked past the position, equal the whole cache's."""
    q_lat, q_rope, c_kv, k_rope = _inputs(256, 32, 40, torch.float32)
    whole = ref.latent_scores_ref(q_lat, q_rope, c_kv, k_rope, 50, 0.2)
    half = ref.latent_scores_ref(q_lat, q_rope, c_kv[:, 35:], k_rope[:, 35:],
                                 50, 0.2, offset=35)
    np.testing.assert_array_equal(half.numpy(), whole[..., 35:].numpy())
    assert bool((whole[..., 51:] == ref.NEG_INF).all())
