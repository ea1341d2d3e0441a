"""The command line, its refusal without a card, the import check on
top-level names, and the result line's schema from a tiny CPU run."""

import ast
import glob
import json
import os
import subprocess
import sys

from skybench import run
from skybench.tests.conftest import ROOT


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "skybench.run", "--workload",
                        "serve-768-f64.broken-0.35", "--seed", str(2 ** 31 + 7),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cloudscape_tpu_torch_fake", object())
    assert "cloudscape_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cloudscape_tpu.engine", object())
    assert run.forbidden_modules() == ["cloudscape_tpu.engine"]


def test_no_module_of_the_harness_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(ROOT, "skybench", "**", "*.py"), recursive=True):
        if os.sep + "tests" + os.sep in path:
            continue
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in run.FORBIDDEN, (path, n)


def test_a_tiny_run_loads_neither_and_prints_the_schema(tiny_root):
    code = ("import json, sys, torch; torch.set_num_threads(2); from skybench import run; "
            f"line = run.measure('serve-768-f64.cycle-0.35', 2**33 + 5, 0.3, False, "
            f"device='cpu', root={tiny_root!r}); "
            "print(json.dumps(run.forbidden_modules())); print(json.dumps(line))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    found, line = (json.loads(x) for x in p.stdout.strip().splitlines()[-2:])
    assert found == []
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"rerender_ms", "quality_db", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
