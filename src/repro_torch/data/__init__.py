"""Datasets of the port (NumPy copies of ``repro.data``)."""
