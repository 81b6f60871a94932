"""remfx_tpu_torch: the PyTorch/CUDA port of ``remfx_tpu``.

A second package beside the JAX one, held against it module by module
(``tests/test_torch_*.py``). It mirrors ``remfx_tpu``'s layout (``ops/``,
``fx/``, ``models/``, ``chain/``, ``data/``, ``utils/``) so that each
module's counterpart is easy to find. It imports ``torch`` and never
``jax`` or ``remfx_tpu``; what it needs of the JAX package is copied.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``utils.device.resolve_device``). The one TPU kernel of the JAX package,
the ballistics envelope (``remfx_tpu/ops/pallas_env.py``), is a
hand-written CUDA kernel here (``csrc/envelope.cu``, ``ops/envelope.py``).
"""

__version__ = "0.1.0"

ALL_EFFECTS = [
    "reverb",
    "chorus",
    "delay",
    "distortion",
    "compressor",
]
"""Canonical effect order defining label indices everywhere.

Mirrors ``Pedalboard_Effects`` (reference remfx/effects.py:699-707):
[Reverb, Chorus, Delay, Distortion, Compressor].
"""

# Class-style names used by the reference's config surface
# (e.g. inference_effects_ordering in cfg/exp/remfx_detect.yaml:80-85).
EFFECT_CLASS_NAMES = {
    "RandomPedalboardReverb": "reverb",
    "RandomPedalboardChorus": "chorus",
    "RandomPedalboardDelay": "delay",
    "RandomPedalboardDistortion": "distortion",
    "RandomPedalboardCompressor": "compressor",
}
