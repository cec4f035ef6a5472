"""Measuring tools of the port; each runs on a CUDA card and is no part of any
training or serving path."""
