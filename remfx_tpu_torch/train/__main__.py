"""Train a removal model or classifier, or test a checkpoint.

The port's counterpart of ``scripts/train.py`` and ``scripts/test.py``:

    python -m remfx_tpu_torch.train +exp=compression_aug \
        datamodule.dataset_type=dynamic datamodule.synthetic=true
    python -m remfx_tpu_torch.train +exp=compression_aug train=false \
        ckpt_path=logs/ckpts/<run>/best

It runs on the card; ``accelerator=cpu`` runs it on the host.
"""

import sys

from remfx_tpu_torch.config.core import parse_cli
from remfx_tpu_torch.train.loop import fit, test


def main(argv=None):
    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    if cfg.get("train", True):
        fit(cfg)
    else:
        test(cfg)


if __name__ == "__main__":
    main()
