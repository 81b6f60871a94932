"""The port stands alone: importing it (and chip_smoke) loads no JAX, and
no file of it imports jax, flax, the JAX package, or the orbax,
tensorstore and zstandard that the JAX package's checkpoints are read
with elsewhere."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "remfx_tpu_torch"
TRAINING_PATH = (
    "config.core", "config.experiments", "data.sources", "data.datasets",
    "models.batchnorm", "ops.resample", "train", "train.__main__",
    "train.checkpoint", "train.loggers", "train.loop", "train.metrics",
    "train.tasks", "utils.heartbeat", "utils.logging", "utils.timing",
)
CHAIN_PATH = (
    "compat.ocdbt", "chain.build", "chain.stream", "cli", "cli.demo_detect",
    "cli.remfx_detect", "cli.chain_inference",
)
BACKBONE_PATH = (
    "models.umx", "models.dptnet", "ops.wiener", "compat.torch_import",
)
CHANNEL_PATH = (
    "fx.phaser", "ops.phaser", "fx.sox_reverb", "fx.chain",
    "models.embedding_classifiers", "cli.generate_dataset", "cli.eval_matrix",
)
PARALLEL_PATH = (
    "parallel", "parallel.mesh", "parallel.launch", "parallel.steps", "parallel.sequence",
    "chain.pipeline",
)
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|remfx_tpu|orbax|tensorstore|zstandard)\b")


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_out():
    code = (
        "import sys, pkgutil, importlib\n"
        "import remfx_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "remfx_tpu_torch.__path__, 'remfx_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ("
        "'jax', 'flax', 'remfx_tpu', 'orbax', 'tensorstore', 'zstandard'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # every module of the port was imported, the training path's too
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 82
    assert {f"remfx_tpu_torch.{m}" for m in TRAINING_PATH + CHAIN_PATH + BACKBONE_PATH
            + CHANNEL_PATH + PARALLEL_PATH} <= names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_lines(path):
    bad = [
        (i + 1, line)
        for i, line in enumerate(path.read_text().splitlines())
        if _FORBIDDEN.match(line)
    ]
    assert not bad, bad


def test_scan_pattern_spares_the_port_itself():
    # the \b keeps remfx_tpu_torch out of the forbidden set
    assert not _FORBIDDEN.match("from remfx_tpu_torch.ops import envelope")
    assert _FORBIDDEN.match("from remfx_tpu.ops import stft")
    assert _FORBIDDEN.match("import jax.numpy as jnp")
    assert _FORBIDDEN.match("import orbax.checkpoint as ocp")
    assert _FORBIDDEN.match("import tensorstore as ts")
