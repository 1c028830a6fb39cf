"""Each driver rehearsed at a tiny size on the CPU, in a temporary copy
of the benchmark to which a configuration, a mix and a per-layer metric
were added as new files plus new entries; the result line; the checks
for a card and for the JAX package."""
import json
import os
import subprocess
import sys
import time

import pytest

from portbench import run as R
from portbench.tests.tiny import REPO

CELLS = ["tiny-ssm.tiny-serve", "tiny-hybrid.tiny-serve"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_driver_prints_the_result_line(tiny_root, cell, trace, capsys):
    res = R.run_cell(tiny_root, cell, 2**31 + 77, 1.5, bool(trace), "cpu",
                     t_start=time.perf_counter())
    R.emit(res)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check failed_requests")
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    names = set(line["metrics"])
    if trace:
        assert {"prefill_ms_p50.serve", "decode_ms_p50.serve", "mfu.serve",
                "window_s.dummy"} <= names
        assert "tokens_per_s" not in names
        assert line["device"]["window_s"] > 0 and "breakdown" in line
    else:
        assert names == {"tokens_per_s", "ttft_ms_p95", "setup_s"}
    for v in line["metrics"].values():
        assert v["value"] > 0


def test_same_seed_same_traffic(tiny_root):
    from portbench.harness import manifest as mf
    from portbench.harness.traffic import RequestStream
    mix = mf.traffic_file(tiny_root, "tiny-serve")
    a, b = RequestStream(mix, 2**33, 256), RequestStream(mix, 2**33, 256)
    c = RequestStream(mix, 2**33 + 1, 256)
    ra, rb, rc = ([s.next() for _ in range(12)] for s in (a, b, c))
    assert all((x.tokens == y.tokens).all() and x.max_new == y.max_new
               for x, y in zip(ra, rb))
    # every block of 4 offers the same sizes, in another order
    sizes = lambda rs: sorted(len(r.tokens) for r in rs)
    news = lambda rs: sorted(r.max_new for r in rs)
    for k in range(3):
        blk = slice(4 * k, 4 * k + 4)
        assert sizes(ra[blk]) == sizes(rc[blk])
        assert news(ra[blk]) == news(rc[blk])
    assert [len(r.tokens) for r in ra] != [len(r.tokens) for r in rc]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert R.forbidden_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jax", object())
    assert R.forbidden_modules() == ["jax", "repro"]


def test_a_run_loads_no_jax(tiny_root):
    code = (f"import sys, time; sys.path[:0] = [{str(REPO)!r}, "
            f"{str(REPO / 'src')!r}]\n"
            "from portbench import run as R\n"
            f"R.run_cell(__import__('pathlib').Path({str(tiny_root)!r}), "
            "'tiny-ssm.tiny-serve', 5, 0.5, True, 'cpu', "
            "t_start=time.perf_counter())\n"
            "print(R.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _main(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mamba2-780m.prefill-long", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd, env=env)


def test_no_card_no_result(tiny_root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _main(tiny_root, env)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    import shutil
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _main(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
