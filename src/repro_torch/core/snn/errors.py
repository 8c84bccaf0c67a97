"""Named declaration/build-time errors for the SNN front-end."""

from __future__ import annotations

__all__ = ["SpecError"]


class SpecError(ValueError):
    """A ModelSpec declaration or build-time validation failure."""
