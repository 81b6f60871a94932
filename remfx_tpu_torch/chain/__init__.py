"""Detect -> remove chain inference of the port."""
