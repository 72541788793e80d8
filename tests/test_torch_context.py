"""``mx.Context`` (ROADMAP A12.7) against the JAX package's, on the CPU.

A Context prints as the JAX package's (``cpu(0)``, ``gpu(1)``), has its
``device_type`` / ``device_id``, and ``with ctx:`` scopes the entry
points of the thread that entered it: inside ``with mx.cpu():`` arrays,
parameters and Modules are made on the host without a ``ctx``; outside
every ``with`` the default stays the card, and asking for it without
one raises. A new thread starts outside every ``with``. Everything that
took a torch device takes a Context (it is the device's string), and
``x.context`` / ``current_context()`` return one.
"""
import pickle
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import mxnet_tpu as jmx  # noqa: E402

import mxnet_tpu_torch as tmx  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402


@pytest.mark.parametrize("make,want", [
    (lambda mx: mx.cpu(), "cpu(0)"), (lambda mx: mx.cpu(1), "cpu(1)"),
    (lambda mx: mx.Context("cpu", 2), "cpu(2)")])
def test_context_prints_and_compares_as_jax(make, want):
    t, j = make(tmx), make(jmx)
    assert repr(t) == repr(j) == str(t) == want
    assert (t.device_type, t.device_id) == (j.device_type, j.device_id)
    assert t == tmx.Context(t.device_type, t.device_id)
    assert hash(t) == hash(tmx.Context(t.device_type, t.device_id))
    assert pickle.loads(pickle.dumps(t)) == t


def test_gpu_context_is_a_torch_device_string():
    g = tmx.gpu(1)
    assert repr(g) == "gpu(1)" and g.device_type == "gpu"
    assert g.device_id == 1 and g.type == "cuda" and g.index == 1
    assert torch.device(g) == torch.device("cuda", 1)
    assert g == torch.device("cuda", 1) and g != tmx.gpu(0)
    assert tmx.Context(torch.device("cuda", 1)) == g
    assert torch.device(tmx.cpu()) == torch.device("cpu")
    assert tmx.cpu() == "cpu" and tmx.cpu() != tmx.cpu(1)
    with pytest.raises(MXNetError, match="device type"):
        tmx.Context("tpu")


def test_array_context_and_repr_match_jax():
    src = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tmx.nd.array(src, ctx=tmx.cpu())
    j = jmx.nd.array(src, ctx=jmx.cpu())
    assert isinstance(t.context, tmx.Context)
    assert (t.context.device_type, t.context.device_id) == ("cpu", 0)
    assert repr(t.context) == repr(j.context) == "cpu(0)"
    assert repr(t).endswith("@cpu(0)>") and repr(j).endswith("@cpu(0)>")
    assert repr(t).splitlines()[-1] == repr(j).splitlines()[-1]
    assert t.as_in_context(tmx.cpu()) is t


def test_with_cpu_scopes_the_entry_points():
    assert tmx.current_context() == tmx.gpu(0)
    with tmx.cpu() as ctx:
        assert tmx.current_context() is ctx
        a = tmx.nd.zeros((2, 2))
        b = tmx.nd.arange(3)
        c = tmx.nd.array([1, 2])
        assert {a.context, b.context, c.context} == {tmx.cpu()}
        net = tmx.gluon.nn.Dense(2, in_units=3)
        net.initialize()
        assert net.weight.data().context == tmx.cpu()
        mod = tmx.mod.Module(tmx.models.mlp(num_classes=3))
        mod.bind(data_shapes=[("data", (2, 4))],
                 label_shapes=[("softmax_label", (2,))])
        mod.init_params()
        assert mod.get_params()[0]["fc1_weight"].context == tmx.cpu()
        with tmx.gpu(0):
            assert tmx.current_context() == tmx.gpu(0)
        assert tmx.current_context() == tmx.cpu()
    assert tmx.current_context() == tmx.gpu(0)
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            tmx.nd.zeros((2,))


def test_context_stack_is_per_thread():
    seen = {}
    entered, release = threading.Event(), threading.Event()

    def worker():
        seen["start"] = tmx.current_context()
        with tmx.cpu(3):
            seen["inside"] = tmx.current_context()
            entered.set()
            release.wait(10)
        seen["after"] = tmx.current_context()

    with tmx.cpu():
        th = threading.Thread(target=worker)
        th.start()
        entered.wait(10)
        # the worker's with does not reach this thread
        assert tmx.current_context() == tmx.cpu()
        release.set()
        th.join(10)
    assert seen == {"start": tmx.gpu(0), "inside": tmx.cpu(3),
                    "after": tmx.gpu(0)}
    # the JAX package's stack is per thread too (its default is cpu(0))
    jseen = []
    with jmx.cpu(1):
        th = threading.Thread(target=lambda: jseen.append(
            jmx.current_context()))
        th.start()
        th.join(10)
    assert jseen == [jmx.cpu(0)]


def test_num_gpus():
    assert tmx.num_gpus() == torch.cuda.device_count()
    if not torch.cuda.is_available():
        assert tmx.num_gpus() == 0


def test_contexts_are_accepted_where_devices_were():
    c = tmx.cpu()
    x = tmx.nd.array(np.ones((2, 3), np.float32), ctx=c)
    assert x.copyto(c).context == c
    y = tmx.nd.random.uniform(shape=(3,), ctx=c)
    assert y.context == c
    assert tmx.random.generator(c).device == torch.device("cpu")
    ex = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=2) \
        .simple_bind(ctx=c, data=(2, 3))
    assert ex.arg_dict["data"].context == c
    assert torch.zeros(1, device=c).device == torch.device("cpu")
