"""Optimizers of the port (the training paths' ``SGD`` and ``Adam`` and
the base they need)."""

from .optimizer import SGD, Adam, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "Adam", "create", "register"]
