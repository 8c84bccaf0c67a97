"""Serving: the slot scheduler and the token server."""
