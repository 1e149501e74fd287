"""Configurations of the port."""
