"""The port's dataset and evaluation entry points
(``remfx_tpu_torch/cli/generate_dataset.py``, ``cli/eval_matrix.py``)
against the JAX package's scripts, on the CPU.

* ``generate_dataset`` renders the layout and the count that
  ``tests/test_cli.py::test_generate_dataset_cli`` checks for the JAX
  script.
* ``eval_matrix``: the test sets of N = 0 and N = 1 are rendered once for
  the module (chunks of 16384 samples, 4 test chunks, batch 4, the rich
  synthetic source) by the port's ``ensure_rendered``; then every cell of
  the three variants is run by both packages' ``run_cell`` on those same
  files, with every trained slot and the trained Cnn14 from ``ckpts/``.
  Both ``build_cfg``s get the chunk override by monkeypatch. Each package
  builds each variant's chain once for the module and reads each
  checkpoint once. Per cell: the detected labels are equal; SI-SDR within
  0.01 dB; MR-STFT and the loss within 1e-4, relative (fp32 chains of five
  networks, measured 1e-6 or closer); ``Input_*`` the same data on both
  sides, within 1e-5. An N = 0 oracle row is the identity: its SI-SDR
  (and every ``Input_SISDR`` of N = 0) is a float-noise floor near 100 dB,
  not comparable across implementations, so it need only be above 80 dB
  on both sides.
* ``write_table`` equals the JAX script's for the same rows; a second
  sweep skips every cell already in ``eval_matrix.json``.
"""

import copy
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import remfx_tpu.chain.build as jbuild
import remfx_tpu.utils.runtime as jruntime
import remfx_tpu_torch.chain.build as tbuild
from remfx_tpu_torch.cli import eval_matrix as tem

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
CHUNK, CHUNKS, BATCH = 16384, 4, 4
CKPTS = ("RandomPedalboardDistortion=ckpts/tcn_distortion_aug",
         "RandomPedalboardCompressor=ckpts/demucs_compressor_aug_r5",
         "RandomPedalboardReverb=ckpts/dcunet_reverb_aug_r4",
         "RandomPedalboardChorus=ckpts/dcunet_chorus_aug_r5",
         "RandomPedalboardDelay=ckpts/dcunet_delay_aug_r5")
CELLS = [f"{v}:{n}" for n in (0, 1) for v in ("oracle", "detect", "all")]


def _jax_script(monkeypatch):
    """scripts/eval_matrix.py as a module, without its runtime set-up (a
    persistent compile cache in the working directory)."""
    monkeypatch.setattr(jruntime, "setup", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "jax_eval_matrix", ROOT / "scripts" / "eval_matrix.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _argv(tmp):
    argv = ["--n", "0,1", "--test-chunks", str(CHUNKS), "--batch", str(BATCH),
            "--root", str(tmp / "data"), "--out", str(tmp / "out"),
            "--classifier", "ckpts/classifier_cnn14_r5", "--real-files", ""]
    for spec in CKPTS:
        argv += ["--ckpt", spec]
    return argv


def _chunked(build_cfg):
    def build(args, exp_name, n):
        cfg = build_cfg(args, exp_name, n)
        cfg["chunk_size"] = CHUNK
        return cfg
    return build


def _cached_chains(module, labels):
    """``module.build_chain`` that builds each variant's chain once and
    records the labels its ``detect`` returns."""
    build, chains = module.build_chain, {}

    def cached(cfg, *args, **kwargs):
        key = json.dumps({k: cfg.get(k) for k in (
            "ckpts", "classifier", "classifier_ckpt", "inference_use_all_effect_models",
            "inference_effects_ordering", "inference_effects_shuffle", "seed")},
            sort_keys=True, default=str)
        if key not in chains:
            chain = build(copy.deepcopy(cfg), *args, **kwargs)
            if chain.classifier is not None:
                detect = chain.detect

                def recorded(x):
                    out = detect(x)
                    labels.append(np.asarray(out).copy() if not torch.is_tensor(out)
                                  else out.cpu().numpy())
                    return out
                chain.detect = recorded
            chains[key] = chain
        return chains[key]
    return cached


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """Both packages' scripts, patched, and the rendered sets."""
    tmp = tmp_path_factory.mktemp("eval_matrix")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ROOT)
        mp.delenv("REMFX_ALLOW_RANDOM_CKPT", raising=False)
        mp.setenv("REMFX_RENDER_REUSE", "1")
        jem = _jax_script(mp)
        labels = {"jax": [], "port": []}
        mp.setattr(jem, "build_cfg", _chunked(jem.build_cfg))
        mp.setattr(tem, "build_cfg", _chunked(tem.build_cfg))
        mp.setattr(jbuild, "build_chain", _cached_chains(jbuild, labels["jax"]))
        mp.setattr(tbuild, "build_chain", _cached_chains(tbuild, labels["port"]))
        argv = _argv(tmp)
        for n in (0, 1):
            args = tem.parse_args(argv + ["--accelerator", "cpu"])
            tem.ensure_rendered(args, tem.build_cfg(args, "remfx_oracle", n))
        yield {"jem": jem, "argv": argv, "labels": labels, "tmp": tmp}


def _cells(matrix, cell, capsys):
    """The row of ``cell`` from each package's run_cell, and the labels
    each chain detected on its batches."""
    labels = matrix["labels"]
    start = {k: len(v) for k, v in labels.items()}
    row = tem.run_cell(tem.parse_args(matrix["argv"] + ["--accelerator", "cpu",
                                                        "--cell", cell]))
    sys_argv = sys.argv
    sys.argv = ["eval_matrix.py"] + matrix["argv"] + ["--cell", cell]
    try:
        matrix["jem"].run_cell(matrix["jem"].parse_args())
    finally:
        sys.argv = sys_argv
    jrow = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return row, jrow, {k: v[start[k]:] for k, v in labels.items()}


@pytest.mark.parametrize("cell", CELLS)
def test_eval_matrix_row_matches_the_jax_script(matrix, cell, capsys):
    row, jrow, labels = _cells(matrix, cell, capsys)
    variant, n = cell.split(":")
    assert (row["variant"], row["n"], row["examples"]) == (variant, int(n), CHUNKS)
    assert set(row) == set(jrow)
    metrics = [k for k in jrow if k.startswith(("test_", "Input_"))]
    assert all(np.isfinite(row[k]) for k in metrics)
    # the detected labels, batch by batch (none for the oracle)
    assert len(labels["port"]) == len(labels["jax"]) == (
        0 if variant == "oracle" else CHUNKS // BATCH)
    for got, want in zip(labels["port"], labels["jax"]):
        np.testing.assert_array_equal(got, want)
    for k in metrics:
        got, want = row[k], jrow[k]
        if k.endswith("SISDR") and want > 80.0:  # the identity's noise floor
            assert got > 80.0, (k, got, want)
        elif k.endswith("SISDR"):
            assert abs(got - want) <= 0.01, (k, got, want)
        elif k.startswith("Input_"):
            assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), (k, got, want)
        else:
            assert abs(got - want) <= 1e-4 * max(abs(want), 1e-3), (k, got, want)
    if cell == "oracle:0":
        assert row["test_SISDR"] > 80.0 and jrow["test_SISDR"] > 80.0


def test_write_table_equals_the_jax_script(matrix, tmp_path):
    rows = [{"variant": "oracle", "n": 0, "test_SISDR": 99.2, "Input_SISDR": 102.1,
             "test_STFT": 0.0, "Input_STFT": 0.0},
            {"variant": "detect", "n": 1, "test_SISDR": 6.513, "Input_SISDR": 8.325,
             "test_STFT": 0.811, "Input_STFT": 0.681},
            {"variant": "all", "n": 1}]
    got = tem.write_table(rows, tmp_path / "port.md")
    want = matrix["jem"].write_table(rows, tmp_path / "jax.md")
    assert got == want
    assert (tmp_path / "port.md").read_text() == (tmp_path / "jax.md").read_text()


def test_second_sweep_skips_every_cell(matrix, monkeypatch, capsys):
    """The sweep runs each missing cell once (here in this process, where
    the sweep starts a subprocess per cell), writes eval_matrix.json and
    the table; a second sweep starts no cell."""
    argv = [a if a != str(matrix["tmp"] / "out") else str(matrix["tmp"] / "sweep")
            for a in matrix["argv"]] + ["--accelerator", "cpu", "--variants", "oracle"]
    started = []

    def in_process(cmd):
        started.append(cmd)
        assert cmd[:3] == [sys.executable, "-m", "remfx_tpu_torch.cli.eval_matrix"]
        assert cmd[cmd.index("--accelerator") + 1] == "cpu"
        return tem.run_cell(tem.parse_args(cmd[3:]))

    monkeypatch.setattr(tem, "cell_row", in_process)
    rows = tem.main(argv)
    assert [c[-1] for c in started] == ["oracle:0", "oracle:1"]
    out = matrix["tmp"] / "sweep"
    assert json.loads((out / "eval_matrix.json").read_text()) == rows
    capsys.readouterr()

    def refuse(cmd):
        raise AssertionError(f"a second sweep started {cmd[-1]}")

    monkeypatch.setattr(tem, "cell_row", refuse)
    assert tem.main(argv) == rows
    printed = capsys.readouterr().out
    assert printed.count("skip ") == 2
    assert (out / "eval_matrix.md").read_text() == tem.write_table(rows, out / "t.md") + "\n"


def test_generate_dataset_writes_the_layout(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "remfx_tpu_torch.cli.generate_dataset",
         "+exp=distortion", "accelerator=cpu", "datamodule.synthetic=true",
         "datamodule.train_chunks=2", "datamodule.val_chunks=1",
         "datamodule.test_chunks=1", "datamodule.render_batch_size=2",
         "chunk_size=8192", f"render_root={tmp_path}"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    rendered = sorted(tmp_path.rglob("input.wav"))
    assert len(rendered) == 4, f"expected 4 rendered chunks, got {len(rendered)}"
    for wav in rendered:
        d = wav.parent
        assert {p.name for p in d.iterdir()} == {
            "input.wav", "target.wav", "dry_effects.pt", "wet_effects.pt"}
    assert {p.parent.parent.name for p in rendered} == {"train", "val", "test"}
