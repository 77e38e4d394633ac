"""Measurement helpers for the port on a CUDA card (nothing here runs on import)."""
