"""Device milliseconds a step of the kernels launched inside torch's
``Optimizer.step#AdamW.step`` range (``train/tasks.py:_apply_gradients``)."""


def read(run):
    return run.trace.device_ms_per("Optimizer.step#AdamW.step", run.iterations)
