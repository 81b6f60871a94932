"""Device milliseconds a batch of the kernels launched inside the
benchmark's ``remove`` range: the regrouped removal stages
(``chain/inference.py:_remove_regrouped``, ``utils/regroup.py``,
``models/wrappers.py``, ``models/demucs.py``, ``models/dcunet.py``)."""


def read(run):
    return run.trace.device_ms_per("remove", run.iterations)
