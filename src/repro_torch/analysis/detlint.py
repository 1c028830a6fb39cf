"""``detlint`` — the determinism / bit-exactness linter for
``src/repro_torch`` (reference ``repro.analysis.detlint``).

Every check below encodes a trap met in this system; each check's
docstring cites where.  Six are the reference's, their path scopes
re-rooted at the port.  The reference's two JAX checks (buffer donation
and ``jax.jit`` around ``pallas_call``) have no subject in a torch tree;
four torch/CUDA rules take their place.  The linter is purely syntactic
(one ``ast`` parse per file, no imports of the linted code),
deterministic, and fast enough to run as a hard CI gate.  String
constants are linted as code, but a docstring or any other bare string
statement is prose and is not.

Suppression syntax — intentional exceptions must be visible in review::

    y.index_add_(0, idx, rows)  # detlint: ignore[det-float-atomics] integer rows; no float sum order

A suppression comment applies to the findings on its own line, or — when
the comment stands alone on a line — to the next line.  Only
suppressions that actually silenced a finding are recorded in the
report; the reason text after the bracket is carried verbatim.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Any, Callable, Iterable

from repro_torch.obs.invariants import CONSERVED_SCHED, CONSERVED_WORKLOAD
from repro_torch.obs.phases import PHASES
from .report import Finding, Suppression

#: Path prefixes (relative to the linted root) where wall-clock reads
#: would contaminate state, snapshots, serialized artifacts, or numerics.
STATE_PATHS = ("serve/", "deploy/", "compress/", "obs/", "core/", "data/",
               "kernels/")

#: Paths where iteration order feeds fused dispatch or stats output.
ORDERED_PATHS = ("serve/", "obs/")

#: Paths whose numbers are held bitwise or to a stated tolerance against
#: a plain version or the reference: no compiler-chosen fusion and no
#: run-to-run sum order there.
EXACT_PATHS = ("serve/", "deploy/", "core/", "kernels/", "compress/",
               "models/")

#: Receiver names that identify tracer objects at span call sites.
_TRACER_NAMES = ("tr", "tracer", "_tracer")

_SUPPRESS_RE = re.compile(
    r"#\s*detlint:\s*ignore\[([a-z0-9\-, ]+)\]\s*(.*)$")

_WALLCLOCK_CALLS = {
    ("time", "time"), ("time", "time_ns"), ("time", "localtime"),
    ("time", "ctime"), ("time", "asctime"), ("time", "strftime"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}

#: Graph compilers: ``torch.compile`` and TorchScript.
_COMPILERS = {("torch", "compile"), ("torch", "jit", "script")}

#: Methods and functions that are float atomics on CUDA whatever their
#: arguments.
_ATOMIC_CALLS = ("index_add", "index_add_", "scatter_add", "scatter_add_",
                 "scatter_reduce", "scatter_reduce_", "index_reduce",
                 "index_reduce_")

#: Methods that are float atomics on CUDA with ``accumulate=True`` (the
#: flag's positional index in the method form).
_ACCUMULATE_CALLS = {"index_put_": 2, "index_put": 2, "put_": 2, "put": 2}

#: nvcc flags that let the compiler change a result's bits (spelled in
#: parts, so that this table is not itself a finding).
_FAST_MATH = tuple(a + b for a, b in (("use_fast", "_math"),
                                      ("fmad", "=true"), ("ftz", "=true")))


def _dotted(node: ast.AST) -> tuple[str, ...]:
    """('a', 'b', 'c') for ``a.b.c``; () when not a plain dotted name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _recv_name(call_func: ast.Attribute) -> str:
    """Last component of the receiver of a method call (``self._tracer``
    -> '_tracer', ``tr`` -> 'tr')."""
    v = call_func.value
    if isinstance(v, ast.Attribute):
        return v.attr
    if isinstance(v, ast.Name):
        return v.id
    return ""


def _is_tracer_recv(call_func: ast.AST) -> bool:
    return (isinstance(call_func, ast.Attribute)
            and _recv_name(call_func) in _TRACER_NAMES)


def _is_true(node: ast.AST | None) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _arg(call: ast.Call, name: str, pos: int) -> ast.AST | None:
    """The argument ``name`` of ``call``, by keyword or at ``pos``."""
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return call.args[pos] if len(call.args) > pos else None


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    doc: str                                   # one line, cites the trap
    scope: Callable[[str], bool]               # relpath -> lint this file?
    run: Callable[[ast.AST, str], Iterable[tuple[int, str]]]


def _everywhere(path: str) -> bool:
    return True


def _state_paths(path: str) -> bool:
    return path.startswith(STATE_PATHS)


def _ordered_paths(path: str) -> bool:
    return path.startswith(ORDERED_PATHS)


def _exact_paths(path: str) -> bool:
    return path.startswith(EXACT_PATHS)


def _span_paths(path: str) -> bool:
    # obs/trace.py implements the primitive (its _Span adapter forwards a
    # caller-supplied phase); consumers everywhere else are in scope.
    return path != "obs/trace.py"


# ---------------------------------------------------------------------------
# Check bodies
# ---------------------------------------------------------------------------

def _check_builtin_hash(tree: ast.AST, path: str):
    """The reference's synthetic HAPT was once seeded via
    ``hash(split)`` — randomized per process by PYTHONHASHSEED, so two
    runs produced different datasets; ``data/hapt.py`` seeds through
    ``zlib.crc32`` in both packages.  ``hash()`` stays banned."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "hash"):
            yield (node.lineno,
                   "builtin hash() is PYTHONHASHSEED-randomized; use "
                   "zlib.crc32 (see data/hapt.py) for stable seeding")


def _check_wallclock(tree: ast.AST, path: str):
    """Wall-clock reads in state, snapshot, or serialized paths break
    byte-identical replay (``obs.metrics`` strips wallclock-tagged fields
    from its snapshot to stay byte-stable; the wire format and the
    ``.fgar`` bytes are compared across packages).  Monotonic
    ``perf_counter`` timing for telemetry is allowed."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if len(d) >= 2 and (d[-2], d[-1]) in _WALLCLOCK_CALLS:
            yield (node.lineno,
                   f"wall-clock call {'.'.join(d)}() in a state/snapshot "
                   f"path; deterministic outputs must not read the clock")


def _check_torch_compile(tree: ast.AST, path: str):
    """A graph compiler picks its own fusion: Inductor contracts a*b+c
    into an FMA, as XLA's jit does in the reference, whose jit/pallas
    step drifts ~1e-9 a step from its NumPy backend for exactly that
    reason (``src/repro/kernels/fastgrnn_cell/qstep.py:16-22``).  The
    port's exact paths hold bitwise contracts (K1-K4 build with
    ``--fmad=false``, ``kernels/_build.py``) and run eagerly; and a
    compiled plain version is not a port of a kernel."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and _dotted(node) in _COMPILERS:
            yield (node.lineno,
                   f"{'.'.join(_dotted(node))} on an exact path: a graph "
                   f"compiler chooses its own fusion (FMA contraction) and "
                   f"changes the bits the port holds")
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            for a in node.names:
                if (node.module or "", a.name) in (("torch", "compile"),
                                                   ("torch.jit", "script")):
                    yield (node.lineno,
                           f"from {node.module} import {a.name} on an exact "
                           f"path: a graph compiler chooses its own fusion")


def _check_float_atomics(tree: ast.AST, path: str):
    """On CUDA ``index_add_``, ``scatter_add_``, ``scatter_reduce_``,
    ``index_reduce_``, ``index_put_``/``put_`` with ``accumulate=True``
    and ``bincount`` with ``weights`` add floats with atomics, in an
    order that changes from run to run.  The reference's MoE combine is
    such a scatter-add (``src/repro/models/moe.py:114``); ported as
    ``index_add_`` it would make a MoE model's logits change bits between
    runs, breaking the engine's reproducible greedy tokens.  The port's
    combine (``models/moe.py``) is a gather and a fixed-order sum."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        name = node.func.attr
        if name in _ATOMIC_CALLS:
            yield (node.lineno,
                   f"{name}() is a float atomic on CUDA: its sum order "
                   f"changes run to run; gather and sum in a fixed order")
        elif name in _ACCUMULATE_CALLS:
            pos = _ACCUMULATE_CALLS[name]
            if _dotted(node.func.value) == ("torch",):
                pos += 1                # torch.index_put(t, ...) form
            if _is_true(_arg(node, "accumulate", pos)):
                yield (node.lineno,
                       f"{name}(..., accumulate=True) is a float atomic on "
                       f"CUDA: its sum order changes run to run")
        elif name == "bincount":
            pos = 1 if _dotted(node.func.value) == ("torch",) else 0
            w = _arg(node, "weights", pos)
            if w is not None and not (isinstance(w, ast.Constant)
                                      and w.value is None):
                yield (node.lineno,
                       "bincount(weights=...) sums float weights with "
                       "atomics on CUDA: its sum order changes run to run")


def _check_tf32(tree: ast.AST, path: str):
    """TF32 rounds a float32 matmul's inputs to 10 mantissa bits.  The
    port's float32 paths are held to the reference's tolerances with it
    off (PyTorch's default for matmuls): the window path's FP32 cell and
    head (``core/pipeline.py``, ``core/fastgrnn.py``), the float32
    oracles of K5 and K6 (``kernels/q15_matmul/kernel.py``,
    ``kernels/ssd_scan/kernel.py``) and the LM's float32 decode-vs-forward
    bound; ``chip_smoke.py`` switches it off for matmuls and cuDNN.
    Nothing in the package may switch it on."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for tgt in targets:
                if not isinstance(tgt, ast.Attribute):
                    continue
                if tgt.attr == "allow_tf32" and _is_true(node.value):
                    yield (node.lineno,
                           "allow_tf32 = True rounds float32 matmul inputs "
                           "to 10 mantissa bits")
                elif (tgt.attr == "fp32_precision"
                      and isinstance(node.value, ast.Constant)
                      and node.value.value == "tf32"):
                    yield (node.lineno,
                           "fp32_precision = 'tf32' rounds float32 matmul "
                           "inputs to 10 mantissa bits")
        elif (isinstance(node, ast.Call) and _dotted(node.func)[-1:]
              == ("set_float32_matmul_precision",)):
            mode = _arg(node, "precision", 0)
            if (isinstance(mode, ast.Constant)
                    and mode.value in ("high", "medium")):
                yield (node.lineno,
                       f"set_float32_matmul_precision({mode.value!r}) lets "
                       f"float32 matmuls run in TF32 or bfloat16")


def _prose(tree: ast.AST) -> set[int]:
    """ids of the string constants that stand as statements of their own
    (docstrings and other bare strings): prose, not code."""
    return {id(node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)}


def _check_fast_math(tree: ast.AST, path: str):
    """The kernels build with ``--fmad=false -prec-div=true`` and never
    with fast math (``kernels/_build.py``): a contracted FMA, approximate
    division or flushed denormals change the bits (or the tolerance) each
    kernel promises against its plain version, and
    ``tests/test_torch_isolation.py`` bans the matching intrinsics in
    the sources.  No string in the package may carry a flag that turns
    them on."""
    prose = _prose(tree)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in prose):
            hit = [f for f in _FAST_MATH if f in node.value]
            if hit:
                yield (node.lineno,
                       f"string {node.value!r} carries the nvcc flag "
                       f"{hit[0]!r}, which changes the exact kernels' bits")


def _check_set_iteration(tree: ast.AST, path: str):
    """Fused-dispatch grouping and stats assembly must not iterate
    containers with unspecified order; a ``set`` iterated into a
    dispatch order or a stats list makes output machine-dependent (the
    fleet's event logs are compared byte for byte with the reference's).
    Sort first (``sorted(set(...))`` is fine)."""
    def is_unordered(it: ast.AST) -> bool:
        if isinstance(it, (ast.Set, ast.SetComp)):
            return True
        return (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id in ("set", "frozenset"))

    for node in ast.walk(tree):
        iters: list[ast.AST] = []
        if isinstance(node, (ast.For, ast.AsyncFor)):
            iters.append(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            iters.extend(g.iter for g in node.generators)
        for it in iters:
            if is_unordered(it):
                yield (it.lineno,
                       "iteration over a set has unspecified order in a "
                       "dispatch/stats path; wrap in sorted(...)")


def _function_scopes(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _walk_own(fn: ast.AST):
    """Walk a function body without descending into nested functions."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _check_span_pairing(tree: ast.AST, path: str):
    """Spans are recorded as a ``t0 = tracer.t()`` /
    ``tracer.rec(phase, t0)`` pair (``obs/trace.py``).  A ``t()`` whose
    result is never passed to ``rec`` is a dropped span (latency silently
    missing from the phase breakdown), and a non-literal phase defeats
    the static registry check."""
    for fn in _function_scopes(tree):
        starts: dict[str, int] = {}
        consumed: set[str] = set()
        for node in _walk_own(fn):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Attribute)
                    and node.value.func.attr == "t"
                    and not node.value.args
                    and _is_tracer_recv(node.value.func)):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        starts[tgt.id] = node.lineno
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("rec", "span")
                    and _is_tracer_recv(node.func)):
                args = node.args
                if not args or not (isinstance(args[0], ast.Constant)
                                    and isinstance(args[0].value, str)):
                    yield (node.lineno,
                           f"span phase passed to .{node.func.attr}() must "
                           f"be a string literal (registry-checkable)")
                if (node.func.attr == "rec" and len(args) >= 2
                        and isinstance(args[1], ast.Name)):
                    consumed.add(args[1].id)
        for name, line in sorted(starts.items()):
            if name not in consumed:
                yield (line,
                       f"span start {name} = tracer.t() is never passed to "
                       f"tracer.rec(...) in {fn.name}() — dropped span")


def _check_span_registry(tree: ast.AST, path: str):
    """Every recorded phase must be in ``repro_torch.obs.phases.PHASES``
    — a typo'd phase silently interns a new ring and splits the latency
    history for that phase (``tests/test_torch_obs.py`` pins the
    registry from the runtime side)."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("rec", "span")
                and _is_tracer_recv(node.func)
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            phase = node.args[0].value
            if phase not in PHASES:
                yield (node.lineno,
                       f"span phase {phase!r} is not registered in "
                       f"repro_torch.obs.phases.PHASES")


def _dict_keys_of(node: ast.AST) -> set[str] | None:
    """String keys of a dict literal or a ``{k: 0 for k in (...)}``
    comprehension over a literal tuple/list; None when not static."""
    if isinstance(node, ast.Dict):
        keys = set()
        for k in node.keys:
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                return None
            keys.add(k.value)
        return keys
    if isinstance(node, ast.DictComp):
        it = node.generators[0].iter if node.generators else None
        if isinstance(it, (ast.Tuple, ast.List)):
            keys = set()
            for e in it.elts:
                if not (isinstance(e, ast.Constant)
                        and isinstance(e.value, str)):
                    return None
                keys.add(e.value)
            return keys
    return None


def _check_conserved_counters(tree: ast.AST, path: str):
    """Fleet totals obey the conservation law live + retired == total
    (``repro_torch.obs.invariants``).  The retired accumulators in
    ``FleetEngine`` and the conservation sets must name the same
    counters, or a crash/rebuild silently loses (or double-counts) a
    counter the invariant no longer covers."""
    expected = {"_retired": set(CONSERVED_WORKLOAD),
                "_retired_sched": set(CONSERVED_SCHED)}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if not (isinstance(tgt, ast.Attribute)
                    and tgt.attr in expected):
                continue
            keys = _dict_keys_of(node.value)
            if keys is None:
                continue
            want = expected[tgt.attr]
            missing, extra = sorted(want - keys), sorted(keys - want)
            if missing or extra:
                detail = []
                if missing:
                    detail.append(f"missing {missing}")
                if extra:
                    detail.append(f"unregistered {extra}")
                yield (node.lineno,
                       f"self.{tgt.attr} keys drift from the "
                       f"obs.invariants conservation sets: "
                       f"{'; '.join(detail)}")


def _engine_path(path: str) -> bool:
    return path.endswith("serve/fleet/engine.py")


#: The check registry.  Order is the report order.
CHECKS: tuple[Check, ...] = (
    Check("det-builtin-hash",
          "no PYTHONHASHSEED-randomized hash() (hash-seeded HAPT)",
          _everywhere, _check_builtin_hash),
    Check("det-wallclock",
          "no wall-clock reads in state/snapshot paths",
          _state_paths, _check_wallclock),
    Check("det-torch-compile",
          "no torch.compile / torch.jit on exact paths (compiler-chosen "
          "FMA fusion, as XLA's jit in the reference)",
          _exact_paths, _check_torch_compile),
    Check("det-float-atomics",
          "no float atomics (index_add, scatter_add, accumulate=True, "
          "weighted bincount) on exact paths (the MoE combine)",
          _exact_paths, _check_float_atomics),
    Check("det-tf32",
          "TF32 never switched on (float32 tolerance paths)",
          _everywhere, _check_tf32),
    Check("det-fast-math",
          "no fast-math / fmad / ftz nvcc flag in any string "
          "(kernels/_build.py's exact flags)",
          _everywhere, _check_fast_math),
    Check("det-set-iteration",
          "no unordered set iteration in dispatch/stats paths",
          _ordered_paths, _check_set_iteration),
    Check("det-span-pairing",
          "t()/rec() spans paired, phases literal",
          _span_paths, _check_span_pairing),
    Check("det-span-registry",
          "span phases drawn from repro_torch.obs.phases.PHASES",
          _span_paths, _check_span_registry),
    Check("det-conserved-counters",
          "retired counters match obs.invariants conservation sets",
          _engine_path, _check_conserved_counters),
)

CHECK_IDS = tuple(c.name for c in CHECKS)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def _suppressions_by_line(src: str) -> dict[int, tuple[set[str], str]]:
    """line number -> (suppressed check ids, reason).  A comment-only
    line's suppression shifts to the following line."""
    out: dict[int, tuple[set[str], str]] = {}
    lines = src.splitlines()
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        checks = {c.strip() for c in m.group(1).split(",") if c.strip()}
        reason = m.group(2).strip()
        target = i + 1 if line.lstrip().startswith("#") else i
        if target in out:
            prev_checks, prev_reason = out[target]
            checks |= prev_checks
            reason = reason or prev_reason
        out[target] = (checks, reason)
    return out


def lint_source(src: str, relpath: str
                ) -> tuple[list[Finding], list[Suppression]]:
    """Lint one file's source.  ``relpath`` is the path relative to the
    linted root (posix separators) — it drives check scoping."""
    tree = ast.parse(src, filename=relpath)
    suppress = _suppressions_by_line(src)
    findings: list[Finding] = []
    suppressions: list[Suppression] = []
    for check in CHECKS:
        if not check.scope(relpath):
            continue
        for line, message in check.run(tree, relpath):
            where = f"{relpath}:{line}"
            sup = suppress.get(line)
            if sup and check.name in sup[0]:
                suppressions.append(Suppression(
                    check=check.name, where=where, reason=sup[1]))
            else:
                findings.append(Finding(
                    check=check.name, where=where, message=message))
    return findings, suppressions


def default_root() -> Path:
    """The ``src/repro_torch`` tree this module itself lives in."""
    return Path(__file__).resolve().parent.parent


def lint_tree(root: Path | str | None = None) -> dict[str, Any]:
    """Lint every ``*.py`` under ``root`` (default: the live
    ``src/repro_torch``).  Returns the detlint block of the analysis
    report."""
    root = Path(root) if root is not None else default_root()
    findings: list[Finding] = []
    suppressions: list[Suppression] = []
    files = sorted(p for p in root.rglob("*.py"))
    for p in files:
        rel = p.relative_to(root).as_posix()
        f, s = lint_source(p.read_text(), rel)
        findings.extend(f)
        suppressions.extend(s)
    return {
        "root": root.name,
        "files": len(files),
        "checks": list(CHECK_IDS),
        "check_docs": {c.name: c.doc for c in CHECKS},
        "findings": [f.to_dict() for f in findings],
        "suppressions": [s.to_dict() for s in suppressions],
    }
