"""Configuration of the port (the render defaults, so far)."""
