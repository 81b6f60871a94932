"""Effect renderers of the port (the compressor, so far)."""
