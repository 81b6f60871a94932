"""Train a removal model or classifier, or test a checkpoint.

The port's counterpart of ``scripts/train.py`` and ``scripts/test.py``:

    python -m remfx_tpu_torch.train +exp=compression_aug \
        datamodule.dataset_type=dynamic datamodule.synthetic=true
    python -m remfx_tpu_torch.train +exp=compression_aug train=false \
        ckpt_path=logs/ckpts/<run>/best

It runs on the card; ``accelerator=cpu`` runs it on the host.
``trainer.devices=N`` (with ``trainer.tensor_parallel=TP``) starts N
ranks, one per card (gloo ranks on the CPU with ``accelerator=cpu``);
started by ``torchrun --nproc-per-node N``, each process is one rank:

    torchrun --nproc-per-node 4 -m remfx_tpu_torch.train \
        +exp=compression_aug trainer.devices=4
"""

import sys

import torch.distributed as dist

from remfx_tpu_torch.config.core import parse_cli
from remfx_tpu_torch.parallel import launch
from remfx_tpu_torch.train.loop import fit, test


def main(argv=None):
    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    ranked = launch.from_torchrun()
    if ranked:
        launch.init_from_env("cpu" if cfg.get("accelerator") == "cpu" else "cuda")
    try:
        if cfg.get("train", True):
            fit(cfg)
        else:
            test(cfg)
    finally:
        if ranked:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
