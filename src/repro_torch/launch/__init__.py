"""Serving (the slot scheduler and the token server) and training."""
