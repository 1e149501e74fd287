"""Drivers of the port: the continuous-batching serving loop so far."""
