"""Comparator-bank tables and plain level encoder (the K1 kernel waits for a later slice)."""
