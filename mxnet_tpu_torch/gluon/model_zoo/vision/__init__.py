"""The vision model zoo and its ``get_model`` (the JAX package's
``gluon/model_zoo/vision/__init__.py``; reference:
python/mxnet/gluon/model_zoo/vision/__init__.py): ResNet v1 / v2, VGG
(with and without BatchNorm), AlexNet, DenseNet, SqueezeNet, Inception
v3 and MobileNet v1 / v2, by the JAX package's names. Every getter takes
``pretrained`` / ``ctx`` / ``root``: ``pretrained=True`` loads
``<root>/<name>.params`` (``model_store.get_model_file``)."""
from .alexnet import *     # noqa: F401,F403
from .densenet import *    # noqa: F401,F403
from .inception import *   # noqa: F401,F403
from .mobilenet import *   # noqa: F401,F403
from .resnet import *      # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *         # noqa: F401,F403
import importlib as _importlib

# the modules, by name: their getters of the same names shadow them here
(_alexnet, _densenet, _inception, _mobilenet, _resnet, _squeezenet,
 _vgg) = [_importlib.import_module("." + m, __name__) for m in (
     "alexnet", "densenet", "inception", "mobilenet", "resnet",
     "squeezenet", "vgg")]

_MODELS = dict(
    [("resnet%d_v%d" % (n, v), getattr(_resnet, "resnet%d_v%d" % (n, v)))
     for v in (1, 2) for n in sorted(_resnet.resnet_spec)] +
    [("vgg%d%s" % (n, bn), getattr(_vgg, "vgg%d%s" % (n, bn)))
     for bn in ("", "_bn") for n in sorted(_vgg.vgg_spec)] +
    [("alexnet", _alexnet.alexnet)] +
    [("densenet%d" % n, getattr(_densenet, "densenet%d" % n))
     for n in sorted(_densenet.densenet_spec)] +
    [("squeezenet1.0", _squeezenet.squeezenet1_0),
     ("squeezenet1.1", _squeezenet.squeezenet1_1),
     ("inceptionv3", _inception.inception_v3)] +
    [("mobilenet%s" % m, getattr(_mobilenet, "mobilenet%s"
                                 % m.replace(".", "_")))
     for m in ("1.0", "0.75", "0.5", "0.25")] +
    [("mobilenetv2_%s" % m, getattr(_mobilenet, "mobilenet_v2_%s"
                                    % m.replace(".", "_")))
     for m in ("1.0", "0.75", "0.5", "0.25")])


def get_model(name, **kwargs):
    """Construct a model by name (reference: vision/__init__.py
    get_model)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError("Model %s is not supported. Available: %s"
                         % (name, sorted(_MODELS)))
    return _MODELS[name](**kwargs)
