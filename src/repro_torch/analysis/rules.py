"""AST invariant rules over the port's tree (port of
``repro/analysis/rules.py``, restated for torch).

  R1  no bare ``assert`` in library code: ``python -O`` strips asserts, so
      a safety check written as one silently disappears. Raise
      ``ValueError`` / ``IndexError``.
  R2  no tracker, span, ``torch.cuda.synchronize`` or ``.item()``
      lexically inside a function that enters ``torch.compile``,
      ``torch.cuda.graph`` or ``torch.cuda.make_graphed_callables`` (or
      inside a ``with torch.cuda.graph(...)`` block): a captured graph
      replays device work only, so host-side observability inside it runs
      once at capture and never again, and a sync or ``.item()`` breaks
      the capture. The torch counterpart of "spans never enter jit".
  R3  every kernel op registered in ``kernels/ops.py`` (a call to
      ``_resolve(impl, "<op>", ...)``) makes a ``_charge("<op>", ...)``
      cost call, names a ``_ref.<fn>`` oracle that exists in
      ``kernels/ref.py``, and is called with ``impl="cuda"`` in some
      ``tests/test_torch_*.py`` (the kernel-vs-plain test on the card).
  R4  dataclasses tagged ``memo key`` in their docstring are
      ``frozen=True``, keep value equality, and keep runtime-only fields
      (``tracker``) out of ``__eq__``/``__hash__`` with
      ``field(compare=False)``: attaching observability must not change
      what a key is.
  R5  no ``torch.float64``, ``torch.double``, ``numpy.float64`` or
      ``.double()``: the port is f32/i32 by contract.
  R6  no ``.synchronize()`` (``torch.cuda.synchronize``,
      ``Event.synchronize``, ``Stream.synchronize``) outside
      ``obs/trace.py``'s span sync: scattered syncs serialize the launch
      queue and make span timings lie about where time goes.
  R7  no import of ``jax``, ``jaxlib`` or the JAX package ``repro``: the
      port keeps its own copy of what it needs.

Suppression: a finding on line N is suppressed by a pragma comment on
line N or N-1 of the form ``# repro-lint: allow[R6] <justification>``.
The justification is mandatory: a bare pragma is itself reported (R0).
Pre-existing findings are suppressed wholesale by the committed baseline
(analysis/findings.py); new code must be clean or justified.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.analysis.findings import Finding

RULE_IDS = ("R1", "R2", "R3", "R4", "R5", "R6", "R7")

# R2: symbols that must not appear lexically inside graph-captured or
# compiled functions. ``.count`` stays allowed, as in the reference.
R2_FORBIDDEN_NAMES = frozenset({
    "Tracker", "span_or_null", "resolve_tracker", "set_default_tracker",
    "default_tracker",
})
R2_FORBIDDEN_ATTRS = frozenset({
    "span", "sync", "synchronize", "item", "observe", "gauge", "event",
})
# R4: the docstring tag and the runtime-only fields kept out of eq/hash
R4_TAG = "memo key"
R4_RUNTIME_FIELDS = frozenset({"tracker"})
R4_RUNTIME_ANNOTATIONS = ("Tracker",)

R5_DTYPES = {("torch", "float64"), ("torch", "double"),
             ("np", "float64"), ("numpy", "float64")}
R6_ALLOWED_SUFFIX = "obs/trace.py"
R7_FORBIDDEN = frozenset({"jax", "jaxlib", "repro"})

_PRAGMA_RE = re.compile(
    r"#\s*repro-lint:\s*allow\[([A-Za-z0-9,\s]+)\]\s*(.*)$")

HINTS = {
    "R1": "raise ValueError/IndexError instead: assert is stripped under "
          "python -O, so the check vanishes in production",
    "R2": "record metrics host-side, outside the compiled or captured "
          "region; a graph replays device work only",
    "R3": "register the op fully: a _ref.<op>_ref plain version in "
          "kernels/ref.py, a _charge(\"<op>\", ...) cost call and a "
          "tests/test_torch_*.py call of the op with impl=\"cuda\"",
    "R4": "declare @dataclasses.dataclass(frozen=True) and exclude "
          "runtime-only fields with dataclasses.field(compare=False)",
    "R5": "keep the port in f32; where a wider intermediate is the point "
          "(an exact product), justify it with # repro-lint: allow[R5]",
    "R6": "wrap the producing expression in a span sync (sp.sync(x), "
          "obs/trace.py) or justify with # repro-lint: allow[R6] <reason>",
    "R7": "the port imports torch, never jax or the JAX package: copy what "
          "it needs into src/repro_torch",
}


# -- helpers ------------------------------------------------------------------


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_entry(dotted: Optional[str]) -> bool:
    """``torch.compile``, ``torch.cuda.graph`` or
    ``[torch.cuda.]make_graphed_callables``."""
    if dotted is None:
        return False
    return (dotted.endswith("torch.compile") or dotted.endswith("cuda.graph")
            or dotted.split(".")[-1] == "make_graphed_callables")


def _mentions_entry(node: ast.AST) -> bool:
    """True when the expression anywhere names torch.compile,
    torch.cuda.graph or make_graphed_callables (``@torch.compile``,
    ``@functools.partial(torch.compile, ...)``)."""
    return any(_is_entry(_dotted(sub)) for sub in ast.walk(node))


def parse_pragmas(source: str, rel: str) -> tuple:
    """(line -> allowed rule ids, R0 findings for unjustified pragmas)."""
    allows: Dict[int, Set[str]] = {}
    bad: List[Finding] = []
    for i, text in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(text)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if not m.group(2).strip():
            bad.append(Finding(
                "R0", rel, i,
                "allow pragma without a justification",
                "write # repro-lint: allow[Rn] <why this is safe>"))
            continue
        allows.setdefault(i, set()).update(rules)
    return allows, bad


def _suppressed(allows: Dict[int, Set[str]], rule: str, line: int) -> bool:
    return any(rule in allows.get(ln, ()) for ln in (line, line - 1))


# -- per-file rules -----------------------------------------------------------


def _r1_bare_assert(tree: ast.Module, rel: str) -> Iterable[Finding]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assert):
            cond = ast.unparse(node.test)
            if len(cond) > 60:
                cond = cond[:57] + "..."
            yield Finding("R1", rel, node.lineno,
                          f"bare assert in library code: `{cond}`",
                          HINTS["R1"])


def _captured_regions(tree: ast.Module) -> Dict[str, List[ast.AST]]:
    """Code that runs compiled or under graph capture, by label: functions
    decorated with (anything mentioning) an entry, functions passed to an
    entry call (through one level of ``functools.partial`` or plain
    rebinding), and the bodies of ``with torch.cuda.graph(...)`` blocks."""
    defs: Dict[str, ast.AST] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node

    marked: Dict[str, List[ast.AST]] = {}
    for name, fn in defs.items():
        if any(_mentions_entry(dec) for dec in fn.decorator_list):
            marked[f"function `{name}`"] = [fn]

    alias: Dict[str, str] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        tgt, val = node.targets[0].id, node.value
        if isinstance(val, ast.Name) and val.id in defs:
            alias[tgt] = val.id
        elif (isinstance(val, ast.Call)
              and (_dotted(val.func) or "").split(".")[-1] == "partial"
              and val.args and isinstance(val.args[0], ast.Name)
              and val.args[0].id in defs):
            alias[tgt] = val.args[0].id

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_entry(_dotted(node.func)):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Name):
                    target = alias.get(arg.id, arg.id)
                    if target in defs:
                        marked[f"function `{target}`"] = [defs[target]]
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if (isinstance(ctx, ast.Call)
                        and _is_entry(_dotted(ctx.func))):
                    marked[f"graph capture at line {node.lineno}"] = list(
                        node.body)
    return marked


def _r2_host_work_in_capture(tree: ast.Module, rel: str
                             ) -> Iterable[Finding]:
    for label, body in _captured_regions(tree).items():
        for stmt in body:
            for node in ast.walk(stmt):
                sym = None
                if (isinstance(node, ast.Name)
                        and node.id in R2_FORBIDDEN_NAMES):
                    sym = node.id
                elif (isinstance(node, ast.Attribute)
                      and node.attr in R2_FORBIDDEN_ATTRS):
                    sym = f".{node.attr}"
                if sym is not None:
                    yield Finding(
                        "R2", rel, node.lineno,
                        f"`{sym}` inside compiled or captured {label}",
                        HINTS["R2"])


def _r4_memo_key_dataclasses(tree: ast.Module, rel: str
                             ) -> Iterable[Finding]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        dec = next((d for d in node.decorator_list
                    if (_dotted(d.func if isinstance(d, ast.Call) else d)
                        or "").split(".")[-1] == "dataclass"), None)
        if dec is None or R4_TAG not in (ast.get_docstring(node) or ""):
            continue
        kw = {k.arg: k.value for k in dec.keywords} \
            if isinstance(dec, ast.Call) else {}
        frozen = kw.get("frozen")
        if not (isinstance(frozen, ast.Constant) and frozen.value is True):
            yield Finding(
                "R4", rel, node.lineno,
                f"memo-key dataclass `{node.name}` is not frozen=True",
                HINTS["R4"])
        eq = kw.get("eq")
        if isinstance(eq, ast.Constant) and eq.value is False:
            yield Finding(
                "R4", rel, node.lineno,
                f"memo-key dataclass `{node.name}` sets eq=False "
                f"(identity equality defeats the memo)", HINTS["R4"])
        for stmt in node.body:
            if not (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                continue
            fname = stmt.target.id
            ann = ast.unparse(stmt.annotation)
            if not (fname in R4_RUNTIME_FIELDS or any(
                    tag in ann for tag in R4_RUNTIME_ANNOTATIONS)):
                continue
            ok = (isinstance(stmt.value, ast.Call)
                  and (_dotted(stmt.value.func) or "").split(".")[-1]
                  == "field"
                  and any(k.arg == "compare"
                          and isinstance(k.value, ast.Constant)
                          and k.value.value is False
                          for k in stmt.value.keywords))
            if not ok:
                yield Finding(
                    "R4", rel, stmt.lineno,
                    f"runtime-only field `{node.name}.{fname}` enters "
                    f"__eq__/__hash__ (needs field(compare=False))",
                    HINTS["R4"])


def _r5_float64(tree: ast.Module, rel: str) -> Iterable[Finding]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            base = _dotted(node.value)
            if (base, node.attr) in R5_DTYPES:
                yield Finding("R5", rel, node.lineno,
                              f"float64 dtype `{base}.{node.attr}`",
                              HINTS["R5"])
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "double" and not node.args):
            yield Finding("R5", rel, node.lineno,
                          f"float64 cast `{ast.unparse(node)[:60]}`",
                          HINTS["R5"])


def _r6_synchronize(tree: ast.Module, rel: str) -> Iterable[Finding]:
    if rel.endswith(R6_ALLOWED_SUFFIX):
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "synchronize":
            yield Finding(
                "R6", rel, node.lineno,
                f"device sync `{_dotted(node) or '.synchronize'}` outside "
                f"obs/trace.py", HINTS["R6"])


def _r7_reference_imports(tree: ast.Module, rel: str) -> Iterable[Finding]:
    for node in ast.walk(tree):
        names: List[str] = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call)
              and (_dotted(node.func) or "").split(".")[-1]
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            names = [node.args[0].value]
        for name in names:
            if name.split(".")[0] in R7_FORBIDDEN:
                yield Finding("R7", rel, node.lineno,
                              f"imports `{name}` (the JAX side)",
                              HINTS["R7"])


# -- cross-module rule: kernel registry (R3) ----------------------------------


def _cuda_parity_ops(tests_root: Path) -> Set[str]:
    """Names of functions called with ``impl="cuda"`` anywhere in
    ``tests_root``'s ``test_torch_*.py``: the wrappers whose kernel has a
    test against its plain version on the card."""
    called: Set[str] = set()
    for p in sorted(Path(tests_root).rglob("test_torch_*.py")):
        try:
            tree = ast.parse(p.read_text())
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = (_dotted(node.func) or "").split(".")[-1]
            for kw in node.keywords:
                if (kw.arg == "impl" and isinstance(kw.value, ast.Constant)
                        and kw.value.value == "cuda"):
                    called.add(name)
    return called


def check_kernel_registry(ops_path: Path, ref_path: Path,
                          rel_ops: Optional[str] = None,
                          tests_root: Optional[Path] = None
                          ) -> List[Finding]:
    """R3 over a kernels/ops.py + kernels/ref.py pair: every op name
    registered through ``_resolve(impl, "<op>", ...)`` must make a
    ``_charge("<op>", ...)`` call, reference a ``_ref.<fn>`` that exists
    in ref.py and, when ``tests_root`` is given, be called with
    ``impl="cuda"`` in one of its ``test_torch_*.py`` (the wrapper
    function is named after its op)."""
    rel_ops = rel_ops or str(ops_path)
    parity_ops: Optional[Set[str]] = None
    if tests_root is not None and Path(tests_root).exists():
        parity_ops = _cuda_parity_ops(Path(tests_root))
    ops_tree = ast.parse(Path(ops_path).read_text())
    ref_tree = ast.parse(Path(ref_path).read_text())
    ref_fns = {n.name for n in ast.walk(ref_tree)
               if isinstance(n, ast.FunctionDef)}
    out: List[Finding] = []
    for fn in ast.walk(ops_tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        op = None
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and (_dotted(node.func) or "").split(".")[-1]
                    == "_resolve" and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)):
                op = node.args[1].value
        if op is None:
            continue
        charged = any(
            isinstance(node, ast.Call)
            and (_dotted(node.func) or "").split(".")[-1] == "_charge"
            and node.args and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == op
            for node in ast.walk(fn))
        if not charged:
            out.append(Finding(
                "R3", rel_ops, fn.lineno,
                f"kernel op `{op}` has no _charge(\"{op}\", ...) cost "
                f"attribution call", HINTS["R3"]))
        oracles = [node.attr for node in ast.walk(fn)
                   if isinstance(node, ast.Attribute)
                   and isinstance(node.value, ast.Name)
                   and node.value.id == "_ref"]
        if not oracles:
            out.append(Finding(
                "R3", rel_ops, fn.lineno,
                f"kernel op `{op}` references no plain version (_ref.*)",
                HINTS["R3"]))
        for o in oracles:
            if o not in ref_fns:
                out.append(Finding(
                    "R3", rel_ops, fn.lineno,
                    f"kernel op `{op}` references _ref.{o} which does not "
                    f"exist in kernels/ref.py", HINTS["R3"]))
        if parity_ops is not None and fn.name not in parity_ops:
            out.append(Finding(
                "R3", rel_ops, fn.lineno,
                f"kernel op `{op}` has no kernel-vs-plain test (no "
                f"tests/test_torch_*.py call of `{fn.name}` with "
                f"impl=\"cuda\")", HINTS["R3"]))
    return out


# -- driver -------------------------------------------------------------------

_FILE_RULES = (_r1_bare_assert, _r2_host_work_in_capture,
               _r4_memo_key_dataclasses, _r5_float64, _r6_synchronize,
               _r7_reference_imports)


def lint_file(path: Path, repo_root: Path, rules=_FILE_RULES
              ) -> List[Finding]:
    """The findings of ``rules`` (default: every per-file rule) for one
    source file, pragma-filtered."""
    path = Path(path)
    rel = path.resolve().relative_to(Path(repo_root).resolve()).as_posix()
    source = path.read_text()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("R0", rel, e.lineno or 1,
                        f"syntax error: {e.msg}", "fix the file")]
    allows, bad_pragmas = parse_pragmas(source, rel)
    out = list(bad_pragmas)
    for rule_fn in rules:
        for f in rule_fn(tree, rel):
            if not _suppressed(allows, f.rule, f.line):
                out.append(f)
    return out


def lint_tree(roots: Sequence[Path], repo_root: Path,
              import_only: Sequence[Path] = ()) -> List[Finding]:
    """Lint every ``*.py`` under ``roots`` (tests/ excluded), then run the
    cross-module kernel-registry rule on any ``kernels/ops.py`` +
    ``kernels/ref.py`` pair found under a root; the files of
    ``import_only`` (scripts beside the package) get R7 alone."""
    repo_root = Path(repo_root).resolve()
    findings: List[Finding] = []
    for root in roots:
        root = Path(root)
        files = sorted(p for p in root.rglob("*.py")
                       if "tests" not in p.parts
                       and "__pycache__" not in p.parts)
        for p in files:
            findings.extend(lint_file(p, repo_root))
        for ops_path in sorted(root.rglob("kernels/ops.py")):
            ref_path = ops_path.with_name("ref.py")
            if ref_path.exists():
                rel = ops_path.resolve().relative_to(repo_root).as_posix()
                findings.extend(
                    check_kernel_registry(ops_path, ref_path, rel,
                                          tests_root=repo_root / "tests"))
    for p in import_only:
        findings.extend(lint_file(p, repo_root,
                                  rules=(_r7_reference_imports,)))
    return sorted(set(findings))
