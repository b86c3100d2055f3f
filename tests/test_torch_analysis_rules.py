"""The port's lint (``repro_torch.analysis.rules`` and ``lint``): one
passing and one violating fixture per rule R1-R7, restated for torch from
``tests/test_analysis_rules.py``, pragma suppression, the baseline round
trip, the CLI's exit codes, and the repository itself lint-clean on its
committed (empty) baseline."""

import json
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import findings as fnd
from repro_torch.analysis import lint as lint_cli
from repro_torch.analysis import rules


def _lint_src(tmp_path: Path, source: str, name="mod.py"):
    p = tmp_path / name
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return rules.lint_file(p, tmp_path)


def _rules_of(found):
    return sorted({f.rule for f in found})


# -- R1: bare assert ----------------------------------------------------------


def test_r1_flags_bare_assert(tmp_path):
    found = _lint_src(tmp_path, """
        def append(self, k):
            assert k <= self.free, "overflow"
    """)
    assert _rules_of(found) == ["R1"]
    assert found[0].line == 3
    assert "k <= self.free" in found[0].message


def test_r1_passes_typed_raise(tmp_path):
    assert _lint_src(tmp_path, """
        def append(self, k):
            if k > self.free:
                raise ValueError("overflow")
    """) == []


# -- R2: host work inside compiled or captured code ---------------------------


def test_r2_flags_span_under_torch_compile(tmp_path):
    found = _lint_src(tmp_path, """
        import torch

        @torch.compile
        def step(tr, x):
            with tr.span("bad"):
                return x + 1
    """)
    assert _rules_of(found) == ["R2"]
    assert "`.span`" in found[0].message and "`step`" in found[0].message


def test_r2_flags_partial_make_graphed_callables_alias(tmp_path):
    found = _lint_src(tmp_path, """
        import functools, torch

        def _decode(x, *, k):
            resolve_tracker(None)
            return x

        def build(x):
            body = functools.partial(_decode, k=5)
            return torch.cuda.make_graphed_callables(body, (x,))
    """)
    assert _rules_of(found) == ["R2"]
    assert "_decode" in found[0].message


@pytest.mark.parametrize("stmt,sym", [
    ("torch.cuda.synchronize()", ".synchronize"),
    ("n = x.sum().item()", ".item"),
])
def test_r2_flags_sync_inside_graph_capture(tmp_path, stmt, sym):
    found = _lint_src(tmp_path, f"""
        import torch

        def capture(g, x):
            with torch.cuda.graph(g):
                y = x * 2
                {stmt}
            return y
    """)
    assert "R2" in _rules_of(found)
    assert any(f.rule == "R2" and f"`{sym}`" in f.message for f in found)


def test_r2_passes_host_side_spans(tmp_path):
    # spans around the compiled call are the sanctioned pattern, and
    # dispatch counting with `.count` stays allowed
    assert _lint_src(tmp_path, """
        import torch

        @torch.compile
        def step(x):
            _dispatch.count("op")
            return x + 1

        def query(tr, x):
            with tr.span("host"):
                return step(x)
    """) == []


def test_r2_ignores_re_compile(tmp_path):
    assert _lint_src(tmp_path, """
        import re

        PAT = re.compile("x")

        def f(tr):
            tr.span("a")
    """) == []


# -- R3: kernel registry ------------------------------------------------------


_OPS_OK = """
def hash_encode(x, *, impl="auto"):
    impl = _resolve(impl, "hash_encode", x)
    _charge("hash_encode", _cost.fn, 1)
    if impl == "ref":
        return _ref.hash_encode_ref(x)
    return x
"""

_REF_OK = """
def hash_encode_ref(x):
    return x
"""


def _registry(tmp_path, ops_src, ref_src, tests=None):
    ops = tmp_path / "ops.py"
    ref = tmp_path / "ref.py"
    ops.write_text(textwrap.dedent(ops_src))
    ref.write_text(textwrap.dedent(ref_src))
    root = None
    if tests is not None:
        root = tmp_path / "tests"
        root.mkdir()
        for name, body in tests.items():
            (root / name).write_text(textwrap.dedent(body))
    return rules.check_kernel_registry(ops, ref, "kernels/ops.py",
                                       tests_root=root)


def test_r3_passes_full_registration(tmp_path):
    assert _registry(tmp_path, _OPS_OK, _REF_OK) == []


def test_r3_flags_missing_charge(tmp_path):
    src = _OPS_OK.replace('    _charge("hash_encode", _cost.fn, 1)\n', "")
    found = _registry(tmp_path, src, _REF_OK)
    assert _rules_of(found) == ["R3"] and "_charge" in found[0].message


def test_r3_flags_missing_plain_version(tmp_path):
    found = _registry(tmp_path, _OPS_OK, "def other_ref(x):\n    return x\n")
    assert _rules_of(found) == ["R3"]
    assert "_ref.hash_encode_ref" in found[0].message


def test_r3_flags_no_plain_version_reference(tmp_path):
    found = _registry(tmp_path, _OPS_OK.replace("_ref.hash_encode_ref(x)",
                                                "x"), _REF_OK)
    assert any("references no plain version" in f.message for f in found)


def test_r3_flags_missing_cuda_test(tmp_path):
    found = _registry(tmp_path, _OPS_OK, _REF_OK, {
        "test_torch_kernels.py": """
            def test_something_else():
                assert ops.hash_encode(x, impl="ref").shape
        """})
    assert _rules_of(found) == ["R3"]
    assert "kernel-vs-plain test" in found[0].message


def test_r3_passes_with_cuda_test(tmp_path):
    assert _registry(tmp_path, _OPS_OK, _REF_OK, {
        "test_torch_cuda.py": """
            def test_hash_encode_equals_plain():
                got = ops.hash_encode(x, impl="cuda")
        """}) == []


def test_r3_counts_only_the_ports_test_files(tmp_path):
    # a reference test calling impl="cuda" would be no card test of the port
    found = _registry(tmp_path, _OPS_OK, _REF_OK, {
        "test_kernels.py": """
            def test_x():
                ops.hash_encode(x, impl="cuda")
        """})
    assert _rules_of(found) == ["R3"]


def test_r3_parity_sweep_skipped_without_tests_root(tmp_path):
    assert _registry(tmp_path, _OPS_OK, _REF_OK) == []
    assert rules.check_kernel_registry(
        tmp_path / "ops.py", tmp_path / "ref.py", "kernels/ops.py",
        tests_root=tmp_path / "no_such_dir") == []


# -- R4: memo-key dataclasses -------------------------------------------------


def test_r4_flags_unfrozen_and_compared_tracker(tmp_path):
    found = _lint_src(tmp_path, """
        import dataclasses

        @dataclasses.dataclass
        class Spec:
            '''A spec (hashable: a memo key).'''
            code_len: int = 32
            tracker: object = None
    """)
    msgs = [f.message for f in found]
    assert _rules_of(found) == ["R4"]
    assert any("not frozen=True" in m for m in msgs)
    assert any("Spec.tracker" in m for m in msgs)


def test_r4_flags_eq_false(tmp_path):
    found = _lint_src(tmp_path, """
        import dataclasses

        @dataclasses.dataclass(frozen=True, eq=False)
        class Plan:
            '''The plan's memo key.'''
            k: int = 1
    """)
    assert _rules_of(found) == ["R4"] and "eq=False" in found[0].message


def test_r4_passes_frozen_with_excluded_tracker(tmp_path):
    assert _lint_src(tmp_path, """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class Spec:
            '''A spec (hashable: a memo key).'''
            code_len: int = 32
            tracker: object = dataclasses.field(
                default=None, compare=False, repr=False)
    """) == []


def test_r4_ignores_untagged_dataclasses(tmp_path):
    assert _lint_src(tmp_path, """
        import dataclasses

        @dataclasses.dataclass
        class Stats:
            '''Mutable accumulator.'''
            n: int = 0
    """) == []


# -- R5: float64 --------------------------------------------------------------


def test_r5_flags_float64_dtypes_and_double(tmp_path):
    found = _lint_src(tmp_path, """
        import numpy as np
        import torch

        def widen(x):
            a = x.to(torch.float64)
            b = torch.zeros(3, dtype=torch.double)
            c = np.zeros(3, np.float64)
            return a, b, c, x.double()
    """)
    assert _rules_of(found) == ["R5"]
    assert len(found) == 4


def test_r5_passes_f32_and_justified_pragma(tmp_path):
    assert _lint_src(tmp_path, """
        import torch

        def fma(a, b, c):
            x = a.to(torch.float32)
            # repro-lint: allow[R5] an f32 product is exact in f64
            return (a.double() * b + c).float()
    """) == []


# -- R6: synchronize ------------------------------------------------------------


@pytest.mark.parametrize("call", ["torch.cuda.synchronize()",
                                  "ev.synchronize()",
                                  "torch.cuda.current_stream().synchronize()"])
def test_r6_flags_stray_sync(tmp_path, call):
    found = _lint_src(tmp_path, f"""
        import torch

        def run(fn, ev):
            out = fn()
            {call}
            return out
    """)
    assert _rules_of(found) == ["R6"]


def test_r6_allows_obs_trace(tmp_path):
    assert _lint_src(tmp_path, """
        import torch

        def sync(x):
            torch.cuda.current_stream(x.device).synchronize()
            return x
    """, name="obs/trace.py") == []


# -- R7: the JAX side ---------------------------------------------------------


@pytest.mark.parametrize("stmt", [
    "import jax", "import jax.numpy as jnp", "from jax import lax",
    "import jaxlib", "from repro.kernels import ops",
    "import repro.core.index",
    "importlib.import_module('repro.obs')",
])
def test_r7_flags_reference_imports(tmp_path, stmt):
    found = _lint_src(tmp_path, f"""
        import importlib

        def f():
            {stmt}
    """)
    assert _rules_of(found) == ["R7"]


def test_r7_passes_the_ports_own_imports(tmp_path):
    assert _lint_src(tmp_path, """
        import numpy as np
        import torch
        from repro_torch.kernels import ops
        import repro_torch.core.index
        from . import sibling
    """) == []


def test_r7_alone_runs_over_the_import_only_files(tmp_path):
    lib = tmp_path / "lib"
    lib.mkdir()
    (lib / "m.py").write_text("x = 1\n")
    script = tmp_path / "chip_smoke.py"
    script.write_text("import torch\nassert torch\ntorch.cuda.synchronize()\n")
    assert rules.lint_tree([lib], tmp_path, [script]) == []
    script.write_text("import jax\n")
    found = rules.lint_tree([lib], tmp_path, [script])
    assert _rules_of(found) == ["R7"] and found[0].path == "chip_smoke.py"


# -- pragmas ------------------------------------------------------------------


def test_pragma_suppresses_same_and_previous_line(tmp_path):
    assert _lint_src(tmp_path, """
        import torch

        def timed(fn):
            # repro-lint: allow[R6] timing harness syncs on purpose
            torch.cuda.synchronize()
            torch.cuda.synchronize()  # repro-lint: allow[R6] ditto
    """) == []


def test_pragma_without_justification_is_r0(tmp_path):
    found = _lint_src(tmp_path, """
        import torch

        def timed(fn):
            torch.cuda.synchronize()  # repro-lint: allow[R6]
    """)
    assert _rules_of(found) == ["R0", "R6"]


def test_pragma_rule_mismatch_does_not_suppress(tmp_path):
    found = _lint_src(tmp_path, """
        import torch

        def timed(fn):
            # repro-lint: allow[R1] wrong rule id
            torch.cuda.synchronize()
    """)
    assert _rules_of(found) == ["R6"]


# -- baseline -----------------------------------------------------------------


def test_baseline_round_trip(tmp_path):
    f1 = fnd.Finding("R1", "a.py", 3, "bare assert in library code: `x`")
    f2 = fnd.Finding("R6", "b.py", 9, "device sync `torch.cuda.synchronize`")
    path = tmp_path / "baseline.json"
    fnd.save_baseline(path, [f1, f2])
    baseline = fnd.load_baseline(path)
    assert len(baseline) == 2
    moved = fnd.Finding("R1", "a.py", 30, f1.message)
    fresh = fnd.Finding("R1", "a.py", 4, "bare assert: `new`")
    new, suppressed = fnd.split_by_baseline([moved, fresh], baseline)
    assert new == [fresh] and suppressed == [moved]


def test_baseline_missing_file_is_empty(tmp_path):
    assert fnd.load_baseline(tmp_path / "nope.json") == {}


def test_baseline_version_mismatch_raises(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text(json.dumps({"version": 99, "findings": []}))
    with pytest.raises(ValueError, match="version"):
        fnd.load_baseline(p)


# -- CLI ----------------------------------------------------------------------


def _tree(tmp_path: Path, source: str) -> Path:
    root = tmp_path / "proj"
    (root / "lib").mkdir(parents=True)
    (root / "lib" / "mod.py").write_text(textwrap.dedent(source))
    return root


def test_cli_exit_1_on_violation_with_location(tmp_path, capsys):
    root = _tree(tmp_path, """
        def f(x):
            assert x > 0
    """)
    rc = lint_cli.run([str(root / "lib"), "--repo-root", str(root),
                       "--baseline", str(tmp_path / "b.json")])
    assert rc == 1
    assert "lib/mod.py:3: R1" in capsys.readouterr().out


def test_cli_exit_0_on_clean_tree(tmp_path):
    root = _tree(tmp_path, """
        def f(x):
            return x + 1
    """)
    assert lint_cli.run([str(root / "lib"), "--repo-root", str(root),
                         "--baseline", str(tmp_path / "b.json")]) == 0


def test_cli_fix_baseline_then_clean(tmp_path, capsys):
    root = _tree(tmp_path, """
        def f(x):
            assert x > 0
    """)
    base = tmp_path / "b.json"
    argv = [str(root / "lib"), "--repo-root", str(root),
            "--baseline", str(base)]
    assert lint_cli.run(argv + ["--fix-baseline"]) == 0
    assert len(json.loads(base.read_text())["findings"]) == 1
    capsys.readouterr()
    assert lint_cli.run(argv) == 0
    assert "1 baselined" in capsys.readouterr().out
    (root / "lib" / "mod.py").write_text(
        "def f(x):\n    assert x > 0\n\ndef g(y):\n    assert y\n")
    assert lint_cli.run(argv) == 1


def test_cli_unknown_root_is_usage_error(tmp_path, capsys):
    assert lint_cli.run([str(tmp_path / "missing")]) == 2
    assert "does not exist" in capsys.readouterr().out


def test_cli_skips_tests_directories(tmp_path):
    root = tmp_path / "proj"
    (root / "lib" / "tests").mkdir(parents=True)
    (root / "lib" / "tests" / "test_x.py").write_text(
        "def test_a():\n    assert 1 == 1\n")
    assert lint_cli.run([str(root / "lib"), "--repo-root", str(root),
                         "--baseline", str(tmp_path / "b.json")]) == 0


# -- the repo itself ----------------------------------------------------------


def test_repo_is_lint_clean():
    """The port and chip_smoke.py hold their invariants with an empty
    baseline."""
    assert lint_cli.run([]) == 0
    assert json.loads(
        lint_cli.DEFAULT_BASELINE.read_text())["findings"] == []
    assert (lint_cli.REPO_ROOT / "chip_smoke.py").exists()


def test_repo_lint_covers_chip_smoke_for_r7(tmp_path, monkeypatch):
    """R7 reaches chip_smoke.py: a copy of the repo's layout whose script
    imports jax fails the default run."""
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "m.py").write_text("import torch\n")
    (tmp_path / "chip_smoke.py").write_text("import jax.numpy\n")
    found = rules.lint_tree([pkg], tmp_path, [tmp_path / "chip_smoke.py"])
    assert [(f.rule, f.path) for f in found] == [("R7", "chip_smoke.py")]
