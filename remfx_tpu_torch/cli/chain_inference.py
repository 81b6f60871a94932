"""Chain inference over an evaluation dataset.

Counterpart of ``scripts/chain_inference.py`` (reference
scripts/chain_inference.py): the config's datamodule and chain, the
chain's ``test_step`` over every test batch, and the mean of each metric
through the config's logger.

    python -m remfx_tpu_torch.cli.chain_inference +exp=remfx_detect \
        render_files=False num_removed_effects=[2,2]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from remfx_tpu_torch.chain.build import build_chain
from remfx_tpu_torch.config.core import parse_cli
from remfx_tpu_torch.train.loggers import make_logger
from remfx_tpu_torch.train.loop import build_datamodule, device_of
from remfx_tpu_torch.utils.logging import get_logger

log = get_logger("chain_inference")


def main(argv=None) -> dict:
    cfg = parse_cli(sys.argv[1:] if argv is None else argv)
    device = device_of(cfg)
    datamodule = build_datamodule(cfg, device)
    chain = build_chain(cfg, None, device=device)
    logger = make_logger(cfg.get("logger", "csv"), cfg["logs_dir"], name="chain_inference")
    logger.log_hyperparams(cfg)
    rows = []
    for batch in datamodule.test_dataloader():
        batch = tuple(torch.as_tensor(t).to(device) for t in batch)
        rows.append({k: float(v) for k, v in chain.test_step(batch).items()})
    means = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    logger.log_metrics(means, 0)
    log.info("chain inference results: %s", {k: round(v, 4) for k, v in means.items()})
    logger.close()
    return means


if __name__ == "__main__":
    main()
