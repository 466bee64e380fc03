"""Vision model zoo of the port: ResNet v1 (18-152).  The reference's
other architectures are not ported yet."""

from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all
from . import resnet as _resnet

__all__ = list(_resnet_all) + ["get_model"]

_MODELS = {name: getattr(_resnet, name) for name in _resnet_all
           if name.startswith("resnet")}


def get_model(name, **kwargs):
    """A zoo model by name (``"resnet50_v1"``, …)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError("Model %s is not supported. Available: %s"
                         % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)
