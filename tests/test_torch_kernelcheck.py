"""The port's kernel registry (``repro_torch.kernels.ops.KERNEL_REGISTRY``)
and kernel checks (``repro_torch.analysis.kernelcheck``, K1-K5).

Against the JAX package: the registry has the reference's keys and shape
classes; each op's cost at each class equals the reference's; each K4
probe's inputs equal the reference's bit for bit (captured from the
reference's own probes), and the port's plain versions on them equal the
reference's ``_ref`` oracles (integers exactly, values within 1e-4 as
``_parity_problems``).

On the CPU the real registry is clean with the probes, the ptxas check
and timings skipped (and the skip reported); the plans of the main
paths' launch shapes fit. Fixture cases turn each fault into its
finding: a leaking wrapper (K4), a mis-billed ``_charge`` or a cost
model above the measured time (K5), an over-budget plan (K1), a short
grid (K2), an undeclared or stale merge (K3), a register-hungry or
unclaimed compiled function (K1). The probes themselves run on the card
(``test_kernelcheck_is_clean_on_the_card``, and ``chip_smoke.py`` phase
11).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.analysis import kernelcheck as kc
from repro_torch.kernels import ops, ref
from repro_torch.kernels.annotations import KernelAnnotation, SentinelSpec
from repro_torch.kernels.ops import LaunchPlan, Stage
from repro_torch.obs import cost as _cost
from repro_torch.parallel.roofline import card_peaks

OPS = tuple(jops.KERNEL_REGISTRY)
H100 = card_peaks("NVIDIA H100 80GB HBM3")
CLASSES = [(op, i) for op in OPS
           for i in range(len(jops.KERNEL_REGISTRY[op].shape_classes))]
# the launch shapes of the main paths at full size (chip_smoke.py phases
# 2, 3 and 7): (kernel, sizes) as ops.launch_shapes records them
PATH_SHAPES = (
    ("hash_encode", (2340373, 150, 32, 1)),
    ("hash_encode", (64, 150, 32, 1)),
    ("hash_encode", (152064, 1024, 122, 4)),
    ("hamming_scan", (64, 2340373, 1)),
    ("hamming_scan", (8, 152064, 2)),
    ("bucket_match", (64, 2250000, 1, 32)),
    ("delta_scan", (64, 1024, 1, 32)),
    ("bucket_gather", (64, 2250000, 73136)),
    ("bucket_gather", (64, 2250000, 2340373)),
    ("fused_query", (64, 2250000, 150, 73136, 40)),
    ("fused_query_int8", (8, 152064, 1024, 152064, 32)),
    ("fused_query", (8, 202240, 5120, 202240, 32)),
    ("mips_topk", (64, 2341909, 150, 10)),
)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _bits(x):
    a = _np(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


# -- the registry against the reference ---------------------------------------


def test_registry_has_the_references_keys_and_shape_classes():
    assert tuple(ops.KERNEL_REGISTRY) == OPS
    for op in OPS:
        assert ops.KERNEL_REGISTRY[op].shape_classes == \
            jops.KERNEL_REGISTRY[op].shape_classes


@pytest.mark.parametrize("op,i", CLASSES)
def test_cost_equals_the_references(op, i):
    reg, jreg = ops.KERNEL_REGISTRY[op], jops.KERNEL_REGISTRY[op]
    s = reg.shape_classes[i]
    assert reg.cost_fn(*reg.cost_args(s)) == jreg.cost_fn(*jreg.cost_args(s))
    assert reg.cost_fn.__name__ == jreg.cost_fn.__name__


def _reference_probe_calls(op, monkeypatch):
    """The (args, kwargs) of each call the reference's probe makes,
    captured from the reference's own probe with its wrapper replaced by a
    recorder that answers with the oracle."""
    calls = []
    oracle = jops.KERNEL_REGISTRY[op].ref_fn

    def recorder(*args, impl=None, **kw):
        calls.append((args, kw))
        return oracle(*args, **kw)

    monkeypatch.setattr(jops, op, recorder)
    problems = getattr(jops, {"hamming_scan": "_probe_hamming"}.get(
        op, f"_probe_{op}"))()
    assert problems == []
    return calls


@pytest.mark.parametrize("op", OPS)
def test_probe_inputs_equal_the_references(op, monkeypatch):
    want = _reference_probe_calls(op, monkeypatch)
    got = ops.probe_inputs(op, "cpu")
    if op == "bucket_gather":      # the reference calls it twice alike
        assert len(want) == 2 and want[0][1] == want[1][1]
        want = want[:1]
    assert len(got) == len(want)
    for (ga, gk), (wa, wk) in zip(got, want):
        assert len(ga) == len(wa) and sorted(gk) == sorted(wk)
        for g, w in zip(list(ga) + [gk[k] for k in sorted(gk)],
                        list(wa) + [wk[k] for k in sorted(wk)]):
            if isinstance(g, torch.Tensor):
                gb, wb = _bits(g), _bits(w)
                assert gb.shape == wb.shape and gb.dtype == wb.dtype
                np.testing.assert_array_equal(gb, wb)
            else:
                assert g == w


@pytest.mark.parametrize("op", OPS)
def test_plain_versions_equal_the_reference_oracles_on_the_probes(op):
    port_fn, jax_fn = ops.KERNEL_REGISTRY[op].ref_fn, \
        jops.KERNEL_REGISTRY[op].ref_fn
    for args, kw in ops.probe_inputs(op, "cpu"):
        jargs = [jnp.asarray(_np(a).view(np.uint32)) if
                 isinstance(a, torch.Tensor) and a.dtype == torch.int32
                 and op not in ("bucket_gather", "fused_query")
                 else jnp.asarray(_np(a)) if isinstance(a, torch.Tensor)
                 else a for a in args]
        jkw = {k: jnp.asarray(_np(v)) for k, v in kw.items()}
        got, want = port_fn(*args, **kw), jax_fn(*jargs, **jkw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            g, w = _bits(g), _bits(w)
            if op == "fused_query" and w.dtype == np.int32:
                # the reference's oracle returns the computed position past
                # a query's take total; the kernels (and the port) give -1
                w = np.where(np.asarray(_np(got[0])) <= ref.NEG / 2, -1, w)
            assert ops._parity_problems(
                op, torch.as_tensor(g), torch.as_tensor(np.array(w)),
                atol=1e-4 if g.dtype == np.float32 else 0.0) == []


# -- the real registry on the CPU ---------------------------------------------


def test_repo_registry_is_clean_on_the_cpu():
    findings, report = kc.run_kernelcheck(device="cpu")
    assert findings == []
    assert report["clean"] == 1
    assert sorted(report["kernels"]) == sorted(OPS)
    rows = [r for v in report["kernels"].values() for r in v["classes"]]
    # every class, and fused_query's classes once more for the int8 build
    assert len(rows) == len(CLASSES) + 2
    assert all("cold_ms" not in r for r in rows)


def test_probes_skipped_on_the_cpu_and_the_skip_printed():
    _, report = kc.run_kernelcheck(device="cpu", probes=True)
    lines = kc.report_lines(report)
    assert "skipped" in lines[-1] and "no CUDA device" in lines[-1]
    assert any(line.startswith("kernelcheck: fused_query int8")
               for line in lines)


def test_lint_kernels_exits_0_and_prints_the_skip(capsys):
    from repro_torch.analysis import lint
    if torch.cuda.is_available():
        pytest.skip("on the card the probes run: chip_smoke.py phase 11")
    assert lint.run(["--kernels"]) == 0
    out = capsys.readouterr().out
    assert "kernelcheck: skipped: no CUDA device" in out


def test_plans_at_the_main_paths_launch_shapes_fit():
    findings, report = kc.run_kernelcheck(device="cpu",
                                          launched=PATH_SHAPES)
    assert findings == []
    assert report["launch_shapes"] == len(PATH_SHAPES)


@pytest.mark.parametrize("kernel,sizes", PATH_SHAPES)
def test_launch_shape_classes_round_trip(kernel, sizes):
    op, s = ops.launch_shape_class(kernel, sizes)
    assert op in ops.KERNEL_REGISTRY
    plan = ops.launch_plan(op, s)
    for st in plan.stages:
        assert st.threads <= 1024 and all(g >= 1 for g in st.grid)


def test_packed_scan_plan_designs():
    wide = ops.packed_scan_plan(64, 2340373, 1)
    assert wide.stages[0].function == "wide_scan_kernel"
    assert wide.stages[0].grid == (2286, 1, 1)
    assert ops.packed_scan_plan(64, 7, 1).stages[0].function == \
        "narrow_scan_kernel"
    assert ops.packed_scan_plan(64, 1024, 9).stages[0].function == \
        "narrow_scan_kernel"
    narrow = ops.packed_scan_plan(64, 1024, 1, live=True)
    assert narrow.stages[0].grid == (128, 1, 1)   # 4 outputs x 128 threads


def test_bucket_gather_plan_walks_queries_past_the_grid_limit():
    plan = ops.bucket_gather_plan(70000, 16, 4096)
    assert plan.stages[0].grid == (2, 65535, 1)
    assert plan.stages[0].tiles[1] == ("queries", 0)
    assert kc.check_k2(ops.KERNEL_REGISTRY["bucket_gather"],
                       {"q": 70000, "s": 16, "p": 4096}, plan) == []


# -- fixture faults -----------------------------------------------------------


def _fx_wrapper(x, *, impl="auto"):
    ops._charge("fx", _cost.packed_scan_cost, 1, 1, 32)
    return x


def _fx_misbilled(x, *, impl="auto"):
    ops._charge("fx", _cost.re_rank_cost, 1, 1, 1)
    return x


def _reg(plan=None, annotation=None, wrapper=_fx_wrapper, probe=None,
         cost_fn=_cost.packed_scan_cost):
    ann = annotation or KernelAnnotation(
        name="fx", grid_names=("rows",), static_smem={"fx_kernel": 0},
        max_threads={"fx_kernel": 256}, pad_contained=True)
    plan = plan or LaunchPlan(
        (Stage("fx_kernel", (4, 1, 1), 256, 0, (("rows", 256),)),),
        {"rows": 1024}, ("rows",))
    return ops.RegisteredKernel(
        op="fx", wrapper=wrapper, entry="fx", annotation=ann,
        cost_fn=cost_fn, cost_args=lambda s: (s["n"], s["n"], 32),
        ref_fn=lambda x: x, plan=lambda s, dev: plan,
        make_inputs=lambda s, dev: ((torch.zeros(s["n"]),), {}),
        shape_classes=({"n": 1024},), probe=probe)


def _run(reg):
    return kc.run_kernelcheck({"fx": reg}, device="cpu")[0]


def _rules(findings):
    return sorted({f.rule for f in findings})


def test_clean_fixture_has_no_findings():
    assert _run(_reg()) == []


def test_over_budget_plan_is_a_k1_finding():
    plan = LaunchPlan(
        (Stage("fx_kernel", (4, 1, 1), 256, ops._SMEM_LIMIT + 4,
               (("rows", 256),)),), {"rows": 1024}, ("rows",))
    found = _run(_reg(plan))
    assert _rules(found) == ["K1"]
    assert "bytes of shared memory" in found[0].message


@pytest.mark.parametrize("stage,what", [
    (Stage("fx_kernel", (4, 1, 1), 2048, 0, (("rows", 256),)), "threads"),
    (Stage("fx_kernel", (4, 70000, 1), 256, 0, (("rows", 256),
                                               ("rows", 0))), "grid"),
    (Stage("other_kernel", (4, 1, 1), 256, 0, (("rows", 256),)),
     "does not claim"),
])
def test_launch_limits_are_k1_findings(stage, what):
    found = _run(_reg(LaunchPlan((stage,), {"rows": 1024}, ("rows",))))
    assert _rules(found) == ["K1"] and what in found[0].message


def test_fused_query_past_the_grid_limit_is_a_k1_finding():
    reg = ops.KERNEL_REGISTRY["fused_query"]
    found = kc.check_k1(reg, {"q": 70000, "total": 64, "d": 32, "k": 8},
                        reg.plan({"q": 70000, "total": 64, "d": 32, "k": 8},
                                 None), ops._SMEM_LIMIT)
    assert found and "outside CUDA's limits" in found[0].message


def test_short_grid_is_a_k2_finding():
    plan = LaunchPlan((Stage("fx_kernel", (3, 1, 1), 256, 0,
                             (("rows", 256),)),), {"rows": 1024}, ("rows",))
    found = _run(_reg(plan))
    assert _rules(found) == ["K2"] and "768 of 1024" in found[0].message


def test_undeclared_merge_is_a_k3_finding_and_a_declared_one_is_not():
    plan = LaunchPlan(
        (Stage("fx_kernel", (4, 8, 1), 256, 0, (("items", 256),
                                                ("rows", 128))),
         Stage("fx_kernel", (1024, 1, 1), 256, 0, (("rows", 1),))),
        {"items": 1024, "rows": 1024}, ("rows",))
    found = _run(_reg(plan))
    assert _rules(found) == ["K3"] and "revisit_dims" in found[0].message
    ann = KernelAnnotation(
        name="fx", grid_names=("items", "rows"), revisit_dims=(0,),
        static_smem={"fx_kernel": 0}, max_threads={"fx_kernel": 256},
        pad_contained=True)
    assert _run(_reg(plan, ann)) == []


def test_stale_revisit_claim_is_a_k3_finding():
    ann = KernelAnnotation(
        name="fx", grid_names=("rows",), revisit_dims=(0,),
        static_smem={"fx_kernel": 0}, max_threads={"fx_kernel": 256},
        pad_contained=True)
    found = _run(_reg(annotation=ann))
    assert _rules(found) == ["K3"] and "stale" in found[0].message


def test_missing_padding_discipline_is_a_k4_finding():
    ann = KernelAnnotation(name="fx", grid_names=("rows",),
                           static_smem={"fx_kernel": 0},
                           max_threads={"fx_kernel": 256})
    found = _run(_reg(annotation=ann))
    assert _rules(found) == ["K4"] and "padding discipline" in \
        found[0].message


def test_stale_sentinel_is_a_k4_finding():
    ann = KernelAnnotation(
        name="fx", grid_names=("rows",), static_smem={"fx_kernel": 0},
        max_threads={"fx_kernel": 256},
        sentinel=SentinelSpec(kind="vals", value=-987654321))
    found = _run(_reg(annotation=ann))
    assert _rules(found) == ["K4"] and "appears in neither" in \
        found[0].message


def test_leaking_wrapper_is_a_k4_finding():
    """A mips_topk whose kernel side lets an out-of-range item win: the
    registry's probe, run against it, reports the leak."""
    def leaking(queries, items, k, *, impl="auto"):
        vals, ids = ops.mips_topk(queries, items, k, impl="ref")
        if impl == "cuda":          # what an unmasked padded row would do
            ids = ids.clone()
            ids[:, 0] = items.shape[0]
            vals = vals.clone()
            vals[:, 0] = 0.0
        return vals, ids

    reg = dataclasses.replace(ops.KERNEL_REGISTRY["mips_topk"],
                              wrapper=leaking)
    found = kc.check_k4(reg, run_probes=True, device="cpu")
    assert _rules(found) == ["K4"]
    msgs = " ".join(f.message for f in found)
    assert "outside [0, N)" in msgs and "parity broke" in msgs


def test_probe_that_raises_is_a_k4_finding_not_a_skip():
    def broken(wrapper, device):
        raise RuntimeError("hash_encode: CUDA launch failed with error 98")
    found = kc.check_k4(_reg(probe=broken), run_probes=True, device="cpu")
    assert _rules(found) == ["K4"] and "probe raised" in found[0].message


def test_misbilled_charge_is_a_k5_finding():
    found = _run(_reg(wrapper=_fx_misbilled))
    assert _rules(found) == ["K5"]
    assert "bills `re_rank_cost`" in found[0].message


def test_real_wrappers_bill_their_registered_cost():
    for reg in ops.KERNEL_REGISTRY.values():
        assert kc.check_k5_billing(reg) == []


def test_cost_above_the_measured_time_is_a_k5_finding():
    reg = ops.KERNEL_REGISTRY["mips_topk"]
    s = {"q": 64, "n": 2340373, "d": 150, "k": 10}
    # the kernel reads each item row once for its one 64-query tile:
    # 1.4 GB, 0.42 ms at 3.35 TB/s, and 4.5e10 FLOPs, 0.67 ms at
    # 67 TFLOP/s; a cold time of 0.2 ms would be faster than both bounds
    row = {"cold_ms": 0.2, **kc.bound_row(reg, s, 0.2, H100)}
    assert row["bytes_share"] > 2 and row["ops_share"] > 3
    assert not row["fits_l2"]
    found = kc.check_k5_bound(reg, "at the exact-baseline shape", row)
    assert _rules(found) == ["K5"] and "overstates" in found[0].message
    small = {"cold_ms": 0.01, **kc.bound_row(reg, reg.shape_classes[0],
                                             0.01, H100)}
    assert small["bytes_share"] is None and small["fits_l2"]
    assert kc.check_k5_bound(reg, "tiny", small) == []


def test_path_bound_holds_the_cost_at_a_paths_shape():
    # phase 10's recall truth, 64 x 17,770 x 300 at k 10, cold 0.139 ms:
    # the billed model (the reference's: every row read once a query)
    # reads 1.38 GB, 0.41 ms at 3.35 TB/s; the kernel reads each row once
    # for its one query tile, 21 MB, which fits the L2
    reg = ops.KERNEL_REGISTRY["mips_topk"]
    s = {"q": 64, "n": 17770, "d": 300, "k": 10}
    billed = reg.cost_fn(*reg.cost_args(s))
    assert 1e3 * billed["hbm_bytes"] / H100.hbm_bytes / 0.139 > 2.9
    row, found = kc.path_bound("mips_topk", (64, 17770, 300, 10), 10,
                               0.139, H100, "at the als path's shape")
    assert row["op"] == "mips_topk" and found == []
    assert row["fits_l2"] and row["bytes_share"] is None
    assert 1e3 * row["hbm_bytes"] / H100.hbm_bytes / 0.139 < 1.05
    assert row["ops_share"] < 1.05
    nblk = ops.launch_plan("mips_topk", s).stages[0].grid[0]
    assert row["hbm_bytes"] == 4 * (17770 * 300 + 64 * 300) \
        + 8 * 64 * 10 * (2 * nblk + 1)
    # phase 4's streaming shape, cold 1.94 ms: a byte share of ~22%
    row, found = kc.path_bound("mips_topk", (64, 2341909, 150, 10), 10,
                               1.94, H100, "at the stream path's shape")
    assert found == [] and 0.2 < row["bytes_share"] < 0.23
    assert not hasattr(kc, "OPEN_K5_FAULTS")
    # the int8 fused head at Qwen3's vocabulary, cold 2.6 ms: k completes
    # the launch shape (q, s, d, total, k')
    row, found = kc.path_bound("fused_query_int8",
                               (8, 151937, 1024, 152064, 40), 10, 2.6,
                               H100, "at the serve path's shape")
    assert found == [] and row["op"] == "fused_query"
    cost = _cost.fused_query_cost(8, 152064, 1024, 10, 40)
    assert row["hbm_bytes"] == cost["hbm_bytes"]
    assert row["bytes_share"] == pytest.approx(
        1e3 * cost["hbm_bytes"] / H100.hbm_bytes / 2.6)


PTXAS = """
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118{fn}ILi1EEEvPKi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118{fn}ILi1EEEvPKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers, {smem} bytes smem, 400 bytes cmem[0]
"""
STRAY = """ptxas info    : Compiling entry function '_Z9stray_fnv' for 'sm_90a'
ptxas info    : Used 8 registers, 380 bytes cmem[0]
"""


def test_parse_ptxas():
    assert kc.parse_ptxas(PTXAS.format(fn="wide_scan_kernel", regs=48,
                                       smem=288) + STRAY) == [
        ("_ZN12_GLOBAL__N_118wide_scan_kernelILi1EEEvPKi", 48, 288),
        ("_Z9stray_fnv", 8, 0)]


def test_ptxas_registers_smem_and_unclaimed_functions_are_k1_findings():
    reg = {"hash_encode": ops.KERNEL_REGISTRY["hash_encode"]}
    # 16 warps of 160 registers: 81,920 > 65,536
    found = kc.check_ptxas(reg, {"hash_encode": PTXAS.format(
        fn="hash_encode_kernel", regs=160, smem=4000) + STRAY})
    msgs = sorted(f.message for f in found)
    assert {f.rule for f in found} == {"K1"} and len(found) == 3
    assert any("160 registers x 512 threads" in m for m in msgs)
    assert any("4000 bytes of static" in m for m in msgs)
    assert any("no op claims it" in m for m in msgs)
    assert kc.check_ptxas(reg, {"hash_encode": PTXAS.format(
        fn="hash_encode_kernel", regs=98, smem=0)}) == []


@pytest.mark.cuda
def test_kernelcheck_is_clean_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probes and timings launch the "
                    "kernels, which have no CPU mode")
    findings, report = kc.run_kernelcheck(device="cuda")
    assert findings == [], [f.format() for f in findings]
    assert report["skipped"] is None
    assert all("cold_ms" in r for v in report["kernels"].values()
               for r in v["classes"])
