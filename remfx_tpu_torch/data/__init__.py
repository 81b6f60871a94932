"""Data helpers of the port (numpy WAV IO)."""
