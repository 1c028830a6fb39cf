"""The port's determinism linter, mutation fixtures and analysis CLI
(``repro_torch.analysis.detlint``, ``selftest``, ``__main__``), mirroring
the detlint, selftest, report and CLI cases of ``tests/test_analysis.py``:

* the live ``src/repro_torch`` tree is detlint-clean under all ten checks,
  with no suppression (each would carry a reason);
* each of the four torch/CUDA rules finds an unsuppressed defect and
  records a suppressed one, and leaves comments, docstrings, the safe
  spellings and out-of-scope paths alone;
* the six checks carried across find what the reference's find on the
  reference's own seeded sources;
* ``run_selftest`` catches every fixture, one per check and rule;
* the report is byte-deterministic, valid under
  ``benchmarks.validate_bench``, and its qlint block (on the reference's
  images, carried across) is the committed ``ANALYSIS_report.json``'s;
* ``python -m repro_torch.analysis`` exits 0 for ``--detlint-only
  --fail-on-findings``, ``--selftest`` and ``--crosscheck``.
"""
import json
import os
import subprocess
import sys

import pytest

from repro.analysis import detlint as jdetlint
from repro.analysis import selftest as jselftest
from repro_torch import weights
from repro_torch.analysis import (CHECK_IDS, CHECKS, analyze_image,
                                  build_report, dumps, lint_source, lint_tree,
                                  run_selftest, write)
from repro_torch.deploy.goldens import build_reference_artifact
from repro_torch.deploy.image import build_image
from torchharness import reference_init

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW_RULES = ("det-torch-compile", "det-float-atomics", "det-tf32",
             "det-fast-math")
CARRIED = ("det-builtin-hash", "det-wallclock", "det-set-iteration",
           "det-span-pairing", "det-span-registry", "det-conserved-counters")


@pytest.fixture(scope="module")
def tree():
    return lint_tree()


@pytest.fixture(scope="module")
def ref_targets():
    """qlint on the reference's seed-0 Q15 and Q7 images (its init
    carried across, threefry under ``False``: ROADMAP C0)."""
    p = weights.params_from_numpy(reference_init())
    return [analyze_image(build_image(build_reference_artifact(
        params=p, bits=bits, device="cpu")), name=f"reference-{label}-s0")
        for bits, label in ((15, "q15"), (7, "q7"))]


# ---------------------------------------------------------------------------
# the live tree
# ---------------------------------------------------------------------------

def test_live_tree_is_detlint_clean(tree):
    assert tree["findings"] == []
    assert len(CHECKS) == len(CHECK_IDS) == 10
    assert list(tree["checks"]) == list(CHECK_IDS)
    assert set(CHECK_IDS) == set(CARRIED) | set(NEW_RULES)
    assert tree["root"] == "repro_torch" and tree["files"] > 80
    assert set(tree["check_docs"]) == set(CHECK_IDS)


def test_live_tree_suppressions_carry_reasons(tree):
    """Every recorded suppression carries a reason; the port has none (the
    MoE combine needs no float atomic)."""
    for s in tree["suppressions"]:
        assert s["reason"], s
    assert tree["suppressions"] == []


# ---------------------------------------------------------------------------
# the four torch/CUDA rules
# ---------------------------------------------------------------------------

# rule -> (path in its scope, defect lines): each line alone is one finding
DEFECTS = {
    "det-torch-compile": ("kernels/x.py", [
        "f = torch.compile(step)",
        "g = torch.jit.script(step)",
        "from torch import compile",
        "from torch.jit import script",
    ]),
    "det-float-atomics": ("models/x.py", [
        "y.index_add_(0, idx, rows)",
        "y = torch.index_add(y, 0, idx, rows)",
        "y.scatter_add_(0, idx, rows)",
        "y = y.scatter_reduce(0, idx, rows, 'sum')",
        "y.index_reduce_(0, idx, rows, 'prod')",
        "y.index_put_((idx,), rows, accumulate=True)",
        "y.index_put_((idx,), rows, True)",
        "y = torch.index_put(y, (idx,), rows, True)",
        "y.put_(idx, rows, accumulate=True)",
        "c = torch.bincount(idx, weights=w)",
        "c = torch.bincount(idx, w)",
        "c = idx.bincount(w)",
    ]),
    "det-tf32": ("analysis/x.py", [
        "torch.backends.cuda.matmul.allow_tf32 = True",
        "torch.backends.cudnn.allow_tf32 = True",
        "torch.set_float32_matmul_precision('high')",
        "torch.set_float32_matmul_precision(precision='medium')",
        "torch.backends.cuda.matmul.fp32_precision = 'tf32'",
    ]),
    "det-fast-math": ("analysis/x.py", [
        "FLAGS = ['-O3', '--use_" "fast_math']",
        "cmd = f'nvcc --fmad=" "true {src}'",
        "FLAGS = ('-ftz=" "true',)",
    ]),
}


def cases():
    for rule, (path, lines) in DEFECTS.items():
        for i, line in enumerate(lines):
            yield pytest.param(rule, path, line, id=f"{rule}-{i}")


@pytest.mark.parametrize("rule,path,line", list(cases()))
def test_new_rule_finds_defect_and_records_suppression(rule, path, line):
    findings, sups = lint_source(line + "\n", path)
    assert [f.check for f in findings] == [rule], findings
    assert findings[0].where == f"{path}:1"
    src = line + f"  # detlint: ignore[{rule}] reviewed\n"
    findings, sups = lint_source(src, path)
    assert findings == []
    assert len(sups) == 1 and sups[0].check == rule
    assert sups[0].reason == "reviewed" and sups[0].where == f"{path}:1"


# sources each new rule must leave alone, with the path they sit at
CLEAN = {
    "prose": ("kernels/x.py", (
        '"""Never torch.compile; index_add_ and scatter_add_ are atomics;\n'
        'allow_tf32 = True and --use_' 'fast_math are banned."""\n'
        "def f():\n"
        '    """set_float32_matmul_precision(\'high\') stays off."""\n'
        "    # y.index_add_(0, idx, rows); torch.compile(f)\n"
        "    return 1\n")),
    "safe-spellings": ("models/x.py", (
        "y.index_put_((idx,), rows, accumulate=False)\n"
        "y.index_put_((idx,), rows)\n"
        "y[idx] = rows\n"
        "c = torch.bincount(idx, minlength=8)\n"
        "c = torch.bincount(idx, weights=None)\n"
        "y = torch.gather(x, 0, idx)\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "torch.set_float32_matmul_precision('highest')\n"
        "FLAGS = ['-O3', '--fmad=false', '-prec-div=true']\n")),
    "out-of-scope": ("analysis/x.py", (
        "f = torch.compile(step)\n"
        "y.index_add_(0, idx, rows)\n")),
}


@pytest.mark.parametrize("case", list(CLEAN))
def test_new_rules_leave_prose_safe_spellings_and_other_paths_alone(case):
    path, src = CLEAN[case]
    findings, sups = lint_source(src, path)
    assert findings == [] and sups == []


def test_moe_combine_needs_no_suppression():
    """The MoE layer, the rule's real target, is clean as it stands."""
    path = os.path.join(REPO, "src", "repro_torch", "models", "moe.py")
    with open(path) as f:
        findings, sups = lint_source(f.read(), "models/moe.py")
    assert findings == [] and sups == []


# ---------------------------------------------------------------------------
# the six checks carried across, on the reference's seeded sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("check", CARRIED)
def test_carried_check_finds_what_the_reference_finds(check):
    path, src = jselftest._DET_SOURCES[check]
    want, _ = jdetlint.lint_source(src, path)
    got, _ = lint_source(src, path)
    assert [(f.check, f.where) for f in got] == \
        [(f.check, f.where) for f in want]
    assert [f.check for f in got] == [check]


# ---------------------------------------------------------------------------
# selftest
# ---------------------------------------------------------------------------

def test_selftest_every_mutation_caught():
    result = run_selftest()
    assert result["ok"], result
    fixtures = result["fixtures"]
    assert len(fixtures) >= 12
    assert all(r["caught"] for r in fixtures.values())
    assert fixtures["acc-width-downgrade"]["caught"]
    for check in CHECK_IDS:
        assert fixtures[f"seeded-{check}"]["expect"] == check
    assert fixtures["suppression-honored"]["caught"]


def test_selftest_image_is_the_reference_fixture(ref_targets):
    """The qlint fixtures' default subject is the committed reference
    image; it proves clean, so each fixture's finding is its defect's."""
    from repro_torch.analysis.selftest import reference_image
    img = reference_image()
    assert len(img.to_bytes()) == 4076
    rec = analyze_image(img, name="reference-q15-s0")
    assert rec == ref_targets[0] and rec["findings"] == []


# ---------------------------------------------------------------------------
# report and CLI
# ---------------------------------------------------------------------------

def test_report_byte_deterministic_and_schema_valid(ref_targets, tree,
                                                    tmp_path):
    from benchmarks.validate_bench import validate
    r1 = dumps(build_report(ref_targets, tree))
    r2 = dumps(build_report([dict(t) for t in ref_targets], lint_tree()))
    assert r1 == r2
    p = tmp_path / "ANALYSIS.json"
    write(build_report(ref_targets, tree), str(p))
    assert p.read_text() == r1
    kind, errors = validate(str(p))
    assert kind == "analysis_report"
    assert errors == []
    rep = json.loads(r1)
    with open(os.path.join(REPO, "ANALYSIS_report.json")) as f:
        committed = json.load(f)
    assert rep["qlint"] == committed["qlint"]
    assert rep["summary"] == {"findings": 0, "suppressed": 0, "ok": True}


def cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": "src"})


def test_cli_detlint_only(tmp_path):
    out = tmp_path / "r.json"
    proc = cli("--detlint-only", "--fail-on-findings", "--report", str(out))
    assert proc.returncode == 0, proc.stderr
    assert "detlint: " in proc.stderr and "10 checks, 0 findings" in \
        proc.stderr
    rep = json.loads(out.read_text())
    assert rep["qlint"] == {"targets": []}
    assert rep["detlint"]["checks"] == list(CHECK_IDS)


def test_cli_selftest():
    proc = cli("--selftest")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all caught" in proc.stdout
    assert "MISSED" not in proc.stdout
    for rule in NEW_RULES:
        assert f"seeded-{rule}" in proc.stdout


def test_cli_crosscheck_on_the_synthetic_split():
    proc = cli("--crosscheck", "--device", "cpu", "--windows", "16")
    assert proc.returncode == 0, proc.stderr
    assert "crosscheck: ok" in proc.stderr
    assert "[stress]: ok (witnessed: gate.hf_clip, h_next" in proc.stderr
