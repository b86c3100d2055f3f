"""kernelcheck: K1-K5 over the registry of hand-written CUDA kernels
(port of ``repro/analysis/kernelcheck.py``, restated for CUDA), run by
``python -m repro_torch.analysis.lint --kernels``.

Every op of ``repro_torch.kernels.ops.KERNEL_REGISTRY`` is checked at each
of its shape classes, and K1-K3 also at any launch shapes handed in (the
sizes ``ops.launch_shapes`` recorded on a path):

  K1  launch resources: every stage of the op's launch plan
      (``ops.launch_plan``, the plan the wrapper launches with) fits the
      card: dynamic plus claimed static shared memory within the opt-in
      limit of a block (the card's, or ``ops._SMEM_LIMIT`` off the card),
      threads a block within 1,024 and the function's claimed maximum,
      grid axes within CUDA's limits. On the card, where the build log
      holds ``ptxas -v`` output, every function's registers times its
      threads fit a block's 65,536 registers and its static shared memory
      is within the annotation's claim.
  K2  coverage: along every grid axis the blocks times the extent a block
      covers reach the axis's size (a grid-stride walk covers any size).
  K3  shared outputs: a first-stage grid axis that does not index the
      op's result (several blocks feeding one result row) must be a
      declared ``revisit_dims`` entry, and a declared one must be such an
      axis; later stages may split result axes only.
  K4  padding: every op declares ``pad_contained`` or a
      :class:`SentinelSpec` whose constant appears in the wrapper or its
      ``.cu`` source; on the card the registry's probes (the reference's
      adversarial padding cases) hold the kernel against its plain
      version. Off the card the probes are skipped and the skip is
      reported; a probe that raises on the card is a finding.
  K5  cost: the wrapper's ``_charge`` call bills the registered
      ``cost_fn`` (an AST check). On the card each class (and each
      variant: fused_query's int8 payload) is timed cold, right after a
      256 MiB write that flushes the L2: the kernel's cost
      (``RegisteredKernel.kernel_cost``: the billed model, or mips_topk's
      own, which reads an item row once a 64-query tile where the billed
      model reads it once a query) has its operations over the card's f32
      rate (hash_encode, whose multiplies and adds round apart,
      over half of it) and its bytes over the card's memory rate
      (``parallel.roofline.PEAKS``; an H100 SXM's 67 TFLOP/s and
      3.35 TB/s) must not exceed 105% of the time. A larger share means
      the cost model, not the kernel, is wrong. A cost whose bytes fit in
      the card's L2 (50 MB) gets no byte share: its inputs may be read
      from L2 after all. :func:`path_bound` holds a cost to the same limit
      at a shape a path launched, against its cold time there
      (``chip_smoke.py`` times the paths' fused_query and mips_topk
      launches cold).

Findings carry the wrapper's ``file:line`` and share the lint baseline
when run through ``python -m repro_torch.analysis.lint --kernels``.
"""

from __future__ import annotations

import ast
import inspect
import statistics
import textwrap
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis import rules
from repro_torch.analysis.findings import Finding
from repro_torch.parallel.roofline import card_peaks

RULE_IDS = ("K1", "K2", "K3", "K4", "K5")

REPO_ROOT = Path(__file__).resolve().parents[3]
MAX_THREADS = 1024
MAX_REGISTERS = 65536      # 32-bit registers a block may hold (sm_90)
GRID_X_MAX, GRID_YZ_MAX = 2 ** 31 - 1, 65535
SHARE_LIMIT = 1.05
FLUSH_BYTES = 256 * 2 ** 20
COLD_REPS = 10

HINTS = {
    "K1": "shrink the stage's shared memory or threads, or fix the plan "
          "so that it equals what the library launches with",
    "K2": "size the grid so that its blocks reach every row of the axis",
    "K3": "declare the merged grid axis in the annotation's revisit_dims, "
          "or split only axes that index the op's result",
    "K4": "declare the padding discipline (pad_contained or a "
          "SentinelSpec) and mask padded lanes before any merge",
    "K5": "bill the registered cost model in the wrapper's _charge call, "
          "and keep the model to the work the kernel must do",
}


def _loc(obj) -> Tuple[str, int]:
    """(repo-relative path, first line) of a callable."""
    try:
        fn = inspect.unwrap(obj)
        src = Path(inspect.getsourcefile(fn)).resolve()
        line = inspect.getsourcelines(fn)[1]
    except (TypeError, OSError):
        return "<unknown>", 1
    try:
        return src.relative_to(REPO_ROOT).as_posix(), line
    except ValueError:
        return src.as_posix(), line


def _finding(rule: str, reg, message: str) -> Finding:
    path, line = _loc(reg.wrapper)
    return Finding(rule, path, line, message, HINTS[rule])


def _shape_text(s: Dict[str, int]) -> str:
    return "{" + ", ".join(f"{k}: {v}" for k, v in s.items()) + "}"


# -- K1: launch resources -----------------------------------------------------


def check_k1(reg, shapes: Dict[str, int], plan, smem_limit: int
             ) -> List[Finding]:
    ann = reg.annotation
    out = []
    where = f"at {_shape_text(shapes)}"
    for st in plan.stages:
        if st.function not in ann.static_smem:
            out.append(_finding(
                "K1", reg, f"`{reg.op}` launches `{st.function}` {where}, "
                           f"which its annotation does not claim"))
            continue
        smem = st.dynamic_smem + ann.static_smem[st.function]
        if smem > smem_limit:
            out.append(_finding(
                "K1", reg, f"`{reg.op}` `{st.function}` {where} needs "
                           f"{smem} bytes of shared memory a block "
                           f"(limit {smem_limit})"))
        cap = min(MAX_THREADS, ann.max_threads.get(st.function,
                                                   MAX_THREADS))
        if not 0 < st.threads <= cap:
            out.append(_finding(
                "K1", reg, f"`{reg.op}` `{st.function}` {where} launches "
                           f"{st.threads} threads a block (at most {cap})"))
        gx, gy, gz = st.grid
        if not (0 < gx <= GRID_X_MAX and 0 < gy <= GRID_YZ_MAX
                and 0 < gz <= GRID_YZ_MAX):
            out.append(_finding(
                "K1", reg, f"`{reg.op}` `{st.function}` {where} has grid "
                           f"{st.grid} outside CUDA's limits"))
    return out


def parse_ptxas(log: str) -> List[Tuple[str, int, int]]:
    """(function, registers, static shared memory bytes) of each kernel
    function in ``nvcc -Xptxas -v`` output."""
    out, name = [], None
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line and "registers" in line and name:
            words = line.replace(",", " ").replace(";", " ").split()
            regs = int(words[words.index("registers") - 1])
            smem = (int(words[words.index("smem") - 2])
                    if "smem" in words else 0)
            out.append((name, regs, smem))
            name = None
    return out


def check_ptxas(registry: Dict[str, Any], build_log: Dict[str, str]
                ) -> List[Finding]:
    """K1 on the compiled functions: registers times the claimed threads
    within a block's registers, static shared memory within the claim,
    and every compiled kernel claimed by some op."""
    out = []
    claims = [(reg, fn) for reg in registry.values()
              for fn in reg.annotation.static_smem]
    for lib, log in sorted(build_log.items()):
        for mangled, regs, smem in parse_ptxas(log):
            owners = [(reg, fn) for reg, fn in claims if fn in mangled]
            if not owners:
                out.append(Finding(
                    "K1", f"src/repro_torch/kernels/csrc/{lib}.cu", 1,
                    f"`{mangled}` is compiled but no op claims it",
                    HINTS["K1"]))
                continue
            for reg, fn in owners:
                threads = reg.annotation.max_threads.get(fn, MAX_THREADS)
                if regs * threads > MAX_REGISTERS:
                    out.append(_finding(
                        "K1", reg, f"`{fn}` uses {regs} registers x "
                                   f"{threads} threads > {MAX_REGISTERS}"))
                claim = reg.annotation.static_smem[fn]
                if smem > claim:
                    out.append(_finding(
                        "K1", reg, f"`{fn}` declares {smem} bytes of static "
                                   f"shared memory, its annotation claims "
                                   f"{claim}"))
    return out


# -- K2/K3: coverage and shared outputs ---------------------------------------


def check_k2(reg, shapes: Dict[str, int], plan) -> List[Finding]:
    out = []
    for st in plan.stages:
        for dim, (axis, extent) in enumerate(st.tiles):
            size = plan.extents.get(axis)
            if size is None:
                out.append(_finding(
                    "K2", reg, f"`{reg.op}` `{st.function}` splits axis "
                               f"`{axis}` the plan gives no size"))
            elif extent and st.grid[dim] * extent < size:
                out.append(_finding(
                    "K2", reg, f"`{reg.op}` `{st.function}` at "
                               f"{_shape_text(shapes)}: {st.grid[dim]} "
                               f"blocks x {extent} cover "
                               f"{st.grid[dim] * extent} of {size} "
                               f"`{axis}`"))
        for dim in range(len(st.tiles), 3):
            if st.grid[dim] != 1:
                out.append(_finding(
                    "K2", reg, f"`{reg.op}` `{st.function}` grid axis {dim} "
                               f"has {st.grid[dim]} blocks over no work "
                               f"axis"))
    return out


def check_k3(reg, plan) -> List[Finding]:
    ann = reg.annotation
    out = []
    for i, st in enumerate(plan.stages):
        for dim, (axis, _) in enumerate(st.tiles):
            merged = axis not in plan.result_axes
            declared = i == 0 and dim in ann.revisit_dims
            if merged and not declared:
                out.append(_finding(
                    "K3", reg, f"`{reg.op}` `{st.function}` grid axis "
                               f"{ann.describe_dim(dim) if i == 0 else dim}"
                               f" splits `{axis}`, which does not index the "
                               f"result: several blocks feed one result row "
                               f"without a revisit_dims declaration"))
            elif declared and not merged:
                out.append(_finding(
                    "K3", reg, f"`{reg.op}` declares revisit on grid axis "
                               f"{ann.describe_dim(dim)}, but it splits "
                               f"result axis `{axis}`: the claim is stale"))
    return out


# -- K4: padding --------------------------------------------------------------


def _source_of(obj) -> str:
    try:
        return inspect.getsource(inspect.unwrap(obj))
    except (TypeError, OSError):
        return ""


def _kernel_source(reg) -> str:
    from repro_torch.kernels import _build
    sig = _build.SIGNATURES.get(reg.entry)
    if sig is None:
        return ""
    path = _build.CSRC / f"{sig[0]}.cu"
    return path.read_text() if path.exists() else ""


def check_k4(reg, *, run_probes: bool, device=None) -> List[Finding]:
    ann = reg.annotation
    out = []
    if ann.sentinel is None and not ann.pad_contained:
        out.append(_finding(
            "K4", reg, f"`{reg.op}` declares no padding discipline (neither "
                       f"pad_contained nor a SentinelSpec)"))
    if ann.sentinel is not None:
        v = ann.sentinel.value
        tokens = {repr(v), str(v), f"{v:g}", f"{v:g}".replace("e+", "e")}
        if ann.sentinel.spelling:
            tokens.add(ann.sentinel.spelling)
        text = _source_of(reg.wrapper) + _kernel_source(reg)
        if not any(t in text for t in tokens):
            out.append(_finding(
                "K4", reg, f"`{reg.op}` declares sentinel {sorted(tokens)[0]}"
                           f" ({ann.sentinel.kind}) but the constant appears "
                           f"in neither the wrapper nor the kernel source"))
    if run_probes and reg.probe is not None:
        try:
            problems = reg.probe(reg.wrapper, device)
        except Exception as e:         # a build or launch error is a finding
            problems = [f"{reg.op}: probe raised {type(e).__name__}: {e}"]
        out += [_finding("K4", reg, f"probe: {p}") for p in problems]
    return out


# -- K5: cost -----------------------------------------------------------------


def _billed_cost_fn_name(wrapper, op: str) -> Optional[str]:
    """The cost function passed to ``_charge("<op>", <fn>, ...)`` in the
    wrapper's source, or None when no such call parses."""
    src = _source_of(wrapper)
    if not src:
        return None
    try:
        tree = ast.parse(textwrap.dedent(src))
    except SyntaxError:
        return None
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and (rules._dotted(node.func) or "").split(".")[-1]
                == "_charge" and len(node.args) >= 2
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == op):
            return (rules._dotted(node.args[1]) or "").split(".")[-1]
    return None


def check_k5_billing(reg) -> List[Finding]:
    billed = _billed_cost_fn_name(reg.wrapper, reg.op)
    if billed is None:
        return [_finding("K5", reg, f"`{reg.op}` makes no _charge(\"{reg.op}"
                                    f"\", ...) call the check can read")]
    if billed != reg.cost_fn.__name__:
        return [_finding("K5", reg, f"`{reg.op}` bills `{billed}` via "
                                    f"_charge but the registry declares "
                                    f"`{reg.cost_fn.__name__}`")]
    return []


def cold_ms(call, flush, reps: int = COLD_REPS) -> float:
    """Median milliseconds of ``call()`` launched alone right after
    ``flush`` is overwritten, so its inputs start outside L2."""
    import torch
    call()
    times = []
    for _ in range(reps):
        flush.add_(1.0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        # repro-lint: allow[R6] a cold timing waits for its own launch
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_row(reg, shapes: Dict[str, int], ms: float, peaks, device=None
              ) -> Dict[str, Any]:
    """The kernel's cost (``reg.kernel_cost`` at ``device``'s launch
    plan) as a bound against a measured time on a card of ``peaks``
    (``parallel.roofline.Peaks``): operations over its f32 rate (half of
    it without FMA), bytes over its memory rate (no byte share where the
    bytes fit in its L2)."""
    cost = reg.kernel_cost(shapes, device)
    rate = peaks.f32_flops if reg.fma else peaks.f32_flops / 2
    ops_ms = 1e3 * cost["flops"] / rate
    bytes_ms = 1e3 * cost["hbm_bytes"] / peaks.hbm_bytes
    fits_l2 = cost["hbm_bytes"] <= peaks.l2_bytes
    return {"flops": float(cost["flops"]),
            "hbm_bytes": float(cost["hbm_bytes"]),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ops_share": ops_ms / ms,
            "bytes_share": None if fits_l2 else bytes_ms / ms,
            "fits_l2": fits_l2}


def check_k5_bound(reg, label: str, row: Dict[str, Any]) -> List[Finding]:
    """A K5 finding for each share of ``row`` above the limit. The message
    names the op, ``label`` and the share's kind but no measured number,
    so that the lint baseline can hold a known fault across runs; the row
    holds the shares."""
    out = []
    for key in ("ops_share", "bytes_share"):
        share = row.get(key)
        if share is not None and share > SHARE_LIMIT:
            out.append(_finding(
                "K5", reg, f"`{reg.op}` {label}: the cost's "
                           f"{key.split('_')[0]} take more than "
                           f"{100 * SHARE_LIMIT:.0f}% of the measured cold "
                           f"time: the cost model overstates the work"))
    return out


def path_bound(kernel: str, sizes: Tuple[int, ...], k: int, ms: float,
               peaks, label: str, device=None
               ) -> Tuple[Dict[str, Any], List[Finding]]:
    """K5 at a shape a path launched: ``kernel``'s cost at the launch
    shape ``sizes`` (an ``ops.launch_shapes`` key; ``k``, the results a
    query, completes fused_query's) against its cold time ``ms`` there on
    ``device``. Returns the bound row (with its ``op``) and its
    findings."""
    from repro_torch.kernels import ops
    op, shapes = ops.launch_shape_class(kernel, tuple(sizes))
    shapes = {**shapes, "k": int(k)}
    reg = ops.KERNEL_REGISTRY[op]
    row = {"op": op, "cold_ms": ms,
           **bound_row(reg, shapes, ms, peaks, device)}
    return row, check_k5_bound(reg, label, row)


# -- driver -------------------------------------------------------------------


def _plan_text(plan) -> str:
    return "; ".join(f"{st.function} grid {st.grid} x {st.threads}"
                     for st in plan.stages)


def run_kernelcheck(registry: Optional[Dict[str, Any]] = None, *,
                    probes: bool = True, device=None,
                    launched: Iterable[Tuple[str, Tuple[int, ...]]] = (),
                    build_log: Optional[Dict[str, str]] = None
                    ) -> Tuple[List[Finding], Dict[str, Any]]:
    """K1-K5 over ``registry`` (default: the real ``KERNEL_REGISTRY``) and
    K1-K3 over the ``launched`` ``(kernel, sizes)`` keys of
    ``ops.launch_shapes``. ``device`` defaults to the card when there is
    one: there the probes (with ``probes``), the ptxas check
    (``build_log``, default the kernels' own build log) and the timings
    run; elsewhere they are skipped and the report says so.

    Returns ``(findings, report)``; the report holds a row per kernel,
    shape class and variant (plan, shared memory, cold ms, bound ms,
    shares)."""
    import torch

    from repro_torch.kernels import _build, ops
    if registry is None:
        registry = ops.KERNEL_REGISTRY
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda")
    device = torch.device(device) if device is not None else None
    on_card = device is not None and device.type == "cuda"
    smem_limit = (getattr(torch.cuda.get_device_properties(device),
                          "shared_memory_per_block_optin", ops._SMEM_LIMIT)
                  if on_card else ops._SMEM_LIMIT)
    peaks = card_peaks(torch.cuda.get_device_name(device)) if on_card \
        else None
    skipped = None if on_card else (
        "no CUDA device: the K4 probes, the ptxas check and the K5 timings "
        "need the card (the kernels have no CPU mode)")

    findings: List[Finding] = []
    table: Dict[str, Any] = {}
    flush = (torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                         device=device) if on_card else None)
    for name, reg in registry.items():
        rows = []
        for shapes in reg.shape_classes:
            plan = reg.plan(shapes, device)
            findings += check_k1(reg, shapes, plan, smem_limit)
            findings += check_k2(reg, shapes, plan)
            findings += check_k3(reg, plan)
            variants = [("", {})] + [
                (label, fn(shapes, device))
                for label, fn in reg.variants]
            for label, extra in variants:
                row = {"shapes": dict(shapes), "variant": label,
                       "plan": _plan_text(plan),
                       "smem": max(st.dynamic_smem
                                   + reg.annotation.static_smem.get(
                                       st.function, 0)
                                   for st in plan.stages)}
                if on_card:
                    args, kw = reg.make_inputs(shapes, device)
                    kw = {**kw, **extra}
                    try:
                        ms = cold_ms(lambda: reg.wrapper(*args, impl="cuda",
                                                         **kw), flush)
                    except Exception as e:
                        findings.append(_finding(
                            "K5", reg, f"`{reg.op}` did not launch at "
                                       f"{_shape_text(shapes)}: "
                                       f"{type(e).__name__}: {e}"))
                        rows.append(row)
                        continue
                    row.update(cold_ms=ms,
                               **bound_row(reg, shapes, ms, peaks, device))
                    findings += check_k5_bound(
                        reg, f"at {_shape_text(shapes)} {label}".rstrip(),
                        row)
                rows.append(row)
        findings += check_k4(reg, run_probes=probes and on_card,
                             device=device)
        findings += check_k5_billing(reg)
        table[name] = {"classes": rows}

    seen = set()
    for kernel, sizes in launched:
        op, shapes = ops.launch_shape_class(kernel, tuple(sizes))
        key = (op, tuple(sorted(shapes.items())))
        if op not in registry or key in seen:
            continue
        seen.add(key)
        reg = registry[op]
        plan = reg.plan(shapes, device)
        findings += check_k1(reg, shapes, plan, smem_limit)
        findings += check_k2(reg, shapes, plan)
        findings += check_k3(reg, plan)
    ptxas = 0
    if on_card:
        log = _build.build_log if build_log is None else build_log
        findings += check_ptxas(registry, log)
        ptxas = sum(len(parse_ptxas(text)) for text in log.values())
    del flush
    findings = sorted(set(findings))
    report = {
        "device": (torch.cuda.get_device_name(device) if on_card
                   else "cpu"),
        "smem_limit": smem_limit,
        "skipped": skipped,
        "launch_shapes": len(seen),
        "ptxas_functions": ptxas,
        "clean": 1 if not findings else 0,
        "findings": [{"rule": f.rule, "path": f.path, "line": f.line,
                      "message": f.message} for f in findings],
        "kernels": table,
    }
    return findings, report


def report_lines(report: Dict[str, Any]) -> List[str]:
    """One line per kernel, shape class and variant, then the skip note."""
    out = []
    for op, ent in report["kernels"].items():
        for r in ent["classes"]:
            label = f"{op} {r['variant']}".rstrip()
            head = (f"kernelcheck: {label} {_shape_text(r['shapes'])}: "
                    f"{r['plan']}, smem {r['smem']} B")
            if "cold_ms" in r:
                bshare = ("fits L2" if r["bytes_share"] is None
                          else f"{100 * r['bytes_share']:.2f}%")
                head += (f", cold {r['cold_ms']:.4f} ms, bound "
                         f"{r['bound_ms']:.6f} ms ({r['bound_by']}), share "
                         f"of the bound: operations "
                         f"{100 * r['ops_share']:.2f}%, bytes {bshare}")
            out.append(head)
    out.append(f"kernelcheck: {len(report['kernels'])} op(s) on "
               f"{report['device']}, smem limit {report['smem_limit']} B, "
               f"{report['launch_shapes']} launch shape(s), "
               f"{report['ptxas_functions']} compiled function(s) checked, "
               f"{len(report['findings'])} finding(s)")
    if report["skipped"]:
        out.append(f"kernelcheck: skipped: {report['skipped']}")
    elif not report["ptxas_functions"]:
        out.append("kernelcheck: no ptxas log: the libraries were built by "
                   "an earlier process, so registers were not checked")
    return out
