"""Utilities of the port: the run log, shape chunking, profiling aids and
the native builds."""
