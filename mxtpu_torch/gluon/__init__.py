"""Gluon pieces of the port: the losses the training path uses."""
