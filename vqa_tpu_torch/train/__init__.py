"""Serving-side training utilities of the port (int8 calibration)."""
