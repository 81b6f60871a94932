"""Device milliseconds a batch of the kernels launched inside the
benchmark's ``detect`` range: Cnn14 with its mel front end
(``chain/inference.py:detect``, ``models/cnn14.py``, ``ops/mel.py``,
``ops/stft.py``)."""


def read(run):
    return run.trace.device_ms_per("detect", run.iterations)
