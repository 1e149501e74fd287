"""Drivers of the port: the continuous-batching serving loop and the co-design campaign CLI."""
