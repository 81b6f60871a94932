"""run.py's refusals, what a run may import, and that a cell, a
configuration and a per-layer metric are added by files and
BENCHMARK.json entries alone."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


def _python(code, cwd=ROOT, path=(ROOT,)):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(map(str, path)))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


def test_run_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    done = subprocess.run([sys.executable, "perfbench/run.py", "--workload", tiny.CHAIN,
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 3
    assert done.stdout == ""
    assert "needs 1 CUDA device" in done.stderr


def test_a_cells_run_loads_no_jax():
    code = ("import torch; torch.set_num_threads(4)\n"
            "from perfbench.tests import tiny\n"
            "from perfbench import run\n"
            "for cell in (tiny.CHAIN, tiny.TRAIN):\n"
            "    assert tiny.run(cell, traced=True)['correct']\n"
            "print(sorted(run.forbidden_modules()))\n")
    done = _python(code)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    """``remfx_tpu_torch`` begins with ``remfx_tpu`` and is allowed."""
    import remfx_tpu_torch  # noqa: F401

    for name in [m for m in sys.modules if m.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert run.forbidden_modules() == set()
    monkeypatch.setitem(sys.modules, "remfx_tpu.chain", object())
    assert run.forbidden_modules() == {"remfx_tpu"}


def test_reference_imports_nothing_of_the_program():
    reference = ROOT / "perfbench" / "reference"
    for path in reference.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in {"remfx_tpu_torch", "remfx_tpu", "jax"}, path
    code = ("import sys, importlib, pathlib\n"
            "for p in sorted(pathlib.Path('perfbench/reference').glob('*.py')):\n"
            "    importlib.import_module('perfbench.reference.' + p.stem)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'remfx_tpu_torch', 'remfx_tpu', 'jax'}))\n")
    done = _python(code)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip() == "[]"


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A copy of BENCHMARK.json and perfbench/ gains a configuration file, a
    workload file and a per-layer metric's reader, and entries naming them;
    no file that was there changes, and the new cell runs by its name."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    spec, config = tiny.chain_inputs()
    (tmp_path / "perfbench/configs/remfx_tiny.json").write_text(json.dumps(config))
    (tmp_path / "perfbench/workloads/chain.tiny.json").write_text(json.dumps(spec))
    (tmp_path / "perfbench/metrics/iterations.tiny.py").write_text(
        "def read(run):\n    return float(run.iterations)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "remfx_tiny", "source": "https://github.com/mhrice/RemFX",
                             "file": "perfbench/configs/remfx_tiny.json", "reduced": [],
                             "why": "a throwaway"})
    bench["workloads"].append({"name": "chain.tiny", "config": "remfx_tiny",
                               "traffic": "chain.tiny", "chips": 1, "why": "a throwaway"})
    for m in bench["end_to_end"]:
        if tiny.CHAIN in m.get("workloads", []):
            m["workloads"].append("chain.tiny")
    bench["per_layer"].append({"name": "iterations.tiny", "unit": "1", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "chain_audio_s_per_s", "workloads": ["chain.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, time, torch\n"
            "torch.set_num_threads(4)\n"
            "import perfbench\n"
            f"assert perfbench.__file__.startswith({str(tmp_path)!r})\n"
            "from perfbench import harness\n"
            "bench = harness.load_json('BENCHMARK.json')\n"
            "spec, config = harness.cell_inputs(bench, 'chain.tiny')\n"
            "out = [harness.run_cell(bench, 'chain.tiny', spec, config, 3, 0.5, traced,\n"
            "                        'cpu', time.perf_counter(), 'cpu') for traced in (False, True)]\n"
            "print(json.dumps(out))\n")
    done = _python(code, cwd=tmp_path, path=(tmp_path, ROOT))
    assert done.returncode == 0, done.stderr[-3000:]
    timed, traced = json.loads(done.stdout.strip().splitlines()[-1])
    assert timed["correct"] and traced["correct"]
    assert set(timed["metrics"]) == {"chain_audio_s_per_s", "chain_batch_ms_p90", "peak_gib",
                                     "setup_s"}
    assert traced["metrics"]["iterations.tiny"]["value"] == spec["trace_iterations"]
    assert all(p.read_bytes() == data for p, data in before.items())


def test_no_file_of_the_benchmark_imports_jax():
    for path in (ROOT / "perfbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            names += [node.args[0].value for node in [node] if isinstance(node, ast.Call)
                      and node.args and isinstance(node.args[0], ast.Constant)
                      and getattr(node.func, "attr", "") in ("import_module", "importorskip")]
            for name in names:
                assert str(name).split(".")[0] not in run.FORBIDDEN, (path, name)


@pytest.mark.parametrize("flags,ok", [((False, False), True), ((True, False), False),
                                      ((False, True), False)])
def test_a_run_is_held_to_the_configurations_tf32(monkeypatch, flags, ok):
    from perfbench import harness

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", flags[0])
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flags[1])
    _, config = harness.cell_inputs(tiny.bench(), tiny.TRAIN)
    assert config["tf32"] is False
    if ok:
        harness.check_precision(config, torch.device("cuda"))
    else:
        with pytest.raises(SystemExit, match="tf32"):
            harness.check_precision(config, torch.device("cuda"))
    harness.check_precision(config, torch.device("cpu"))  # no TF32 on the CPU


class _Trace:
    device = [(0.0, 1.0, "k", None, None)]
    busy_s = 1.2


class _Cell:
    @staticmethod
    def flops_per_iteration():
        return 67e12 * 0.1


def test_shares_of_time_are_taken_over_the_untraced_iteration():
    """Three traced iterations busy 1.2 s in all; an untraced one 0.5 s."""
    from perfbench import harness

    r = harness.Run(_Trace(), 3, 0.5, _Cell(), {"fp32_flops": 67e12})
    assert r.idle_pct() == pytest.approx(20.0)
    assert r.share_of_peak("fp32_flops") == pytest.approx(20.0)
    assert harness.Run(_Trace(), 3, 0.5, _Cell(), None).share_of_peak("fp32_flops") is None
    _Trace.device = []
    try:
        assert r.idle_pct() is None and r.share_of_peak("fp32_flops") is None
    finally:
        _Trace.device = [(0.0, 1.0, "k", None, None)]


def test_per_layer_metrics_are_those_that_list_the_cell():
    from perfbench import harness

    bench = tiny.bench()
    for cell in (tiny.CHAIN, tiny.TRAIN):
        got = {m["name"] for m in harness.per_layer(bench, cell)}
        assert got and all(m["workloads"] == [cell] for m in bench["per_layer"]
                           if m["name"] in got)
        assert all(n.endswith("." + cell.split(".")[0]) for n in got)
