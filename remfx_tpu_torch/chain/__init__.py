"""Detect -> remove chain inference of the port (``inference.py``), built
from checkpoints (``build.py``), over long files (``stream.py``) and one
stage per device (``pipeline.py``)."""
