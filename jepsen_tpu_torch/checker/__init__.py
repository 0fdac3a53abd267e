"""Checkers: the linearizable checker and its exact CPU engines."""

from .linearizable import Linearizable, linearizable

__all__ = ["Linearizable", "linearizable"]
