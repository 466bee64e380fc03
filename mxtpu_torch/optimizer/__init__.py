"""Optimizers of the port (the training path's ``Adam`` and the base it
needs)."""

from .optimizer import Adam, Optimizer, create, register

__all__ = ["Optimizer", "Adam", "create", "register"]
