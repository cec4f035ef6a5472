"""Utilities of the port (the run log)."""
