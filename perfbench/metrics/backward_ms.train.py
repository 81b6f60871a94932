"""Device milliseconds a step of the kernels launched inside autograd's
``autograd::engine::evaluate_function: ...`` ranges: the model's backward
pass under ``RemovalTask.train_step``."""


def read(run):
    return run.trace.device_ms_per("autograd::engine::evaluate_function", run.iterations)
