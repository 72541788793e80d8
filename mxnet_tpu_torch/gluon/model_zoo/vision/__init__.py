"""The vision model zoo's ``get_model`` (the JAX package's
``gluon/model_zoo/vision/__init__.py``): the ResNets, v1 and v2, 18-152.
The zoo's other families (VGG, AlexNet, DenseNet, SqueezeNet, Inception,
MobileNet) raise naming ROADMAP A12.3."""
from .resnet import *  # noqa: F401,F403
from . import resnet as _resnet

_NOT_PORTED = ("vgg", "alexnet", "densenet", "squeezenet", "inception",
               "mobilenet")


def get_model(name, **kwargs):
    """Construct a model by name (reference: vision/__init__.py
    get_model); ``pretrained=True`` raises (no weights are fetched)."""
    name = name.lower()
    models = {"resnet%d_v%d" % (n, v): getattr(_resnet, "resnet%d_v%d"
                                                % (n, v))
              for n in _resnet.resnet_spec for v in (1, 2)}
    if name in models:
        return models[name](**kwargs)
    if name.startswith(_NOT_PORTED):
        raise NotImplementedError(
            "model %s is not ported to mxnet_tpu_torch: the zoo has the "
            "ResNets; the rest is ROADMAP A12.3" % name)
    raise ValueError("Model %s is not supported. Available: %s"
                     % (name, sorted(models)))
