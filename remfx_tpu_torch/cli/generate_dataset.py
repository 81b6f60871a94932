"""Render a dataset to disk.

Counterpart of ``scripts/generate_dataset.py`` (reference
scripts/generate_dataset.py): the config's datamodule, built for its side
effect, which renders every split to ``render_root`` in the reference's
directory layout.

    python -m remfx_tpu_torch.cli.generate_dataset +exp=5-5
"""

from __future__ import annotations

import sys

from remfx_tpu_torch.config.core import parse_cli
from remfx_tpu_torch.train.loop import build_datamodule


def main(argv=None):
    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    return build_datamodule(cfg)  # side effect: renders to disk


if __name__ == "__main__":
    main()
