"""Of the rows the removal models ran in the regroup dispatch, the share in
percent that no label selected (regroup's padding rows, or the dense
stage's unselected rows): the port's counters
``ChainInference.regroup_unselected`` over ``ChainInference.regroup_rows``
(``chain/inference.py:_remove_regrouped``). They count over the process,
set-up's batches too; with the cell's fixed label counts every batch
gives the same share. None where the program has no such counters."""


def read(run):
    from remfx_tpu_torch.chain.inference import ChainInference

    rows = getattr(ChainInference, "regroup_rows", 0)
    if not rows:
        return None
    return 100.0 * ChainInference.regroup_unselected / rows
