"""Gluon pieces of the port: the block base, the layers, the vision model
zoo, the losses and the ``Trainer``."""
