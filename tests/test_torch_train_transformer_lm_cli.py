"""The port's ``train_transformer_lm`` CLI against the JAX package's.

``mxnet_tpu_torch.examples.train_transformer_lm.main(argv, device="cpu")``
with the flags test_parallel_5d.py:306-308 gives the JAX CLI
(``examples/train_transformer_lm.py``, run in this process with the
same flags) its printed lines: the same steps, losses within 1e-3 (both
print four decimals of float32 losses that agree within 1e-4), the same
``mesh=`` line and the same generated-token match; with
``--num-experts`` too. A mesh axis above 1 raises naming its ROADMAP
item.
"""
import contextlib
import io
import os
import re
import runpy
import sys

import pytest

pytest.importorskip("jax")

from mxnet_tpu_torch.examples import train_transformer_lm as cli  # noqa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--mesh", "1,1,1,1,1", "--steps", "6", "--d-model", "32",
         "--n-layers", "2", "--d-ff", "64", "--seq-len", "64",
         "--generate", "8"]
NUM = re.compile(r"-?\d+\.\d+|-?\d+")


def _jax_cli(argv):
    script = os.path.join(ROOT, "examples", "train_transformer_lm.py")
    buf = io.StringIO()
    old = sys.argv
    sys.argv = [script] + argv
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(script, run_name="__main__")
    finally:
        sys.argv = old
    return buf.getvalue()


def _port_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv, device="cpu")
    return buf.getvalue(), out


def _lines(text):
    """(kind, numbers) per printed line, the seconds of step lines out."""
    rows = []
    for line in text.strip().splitlines():
        if line.startswith("step"):
            step, loss = line.split()[1], line.split()[3]
            rows.append(("step", [int(step), float(loss)]))
        else:
            rows.append((line.split()[0], [float(x) for x in
                                           NUM.findall(line)]))
    return rows


@pytest.mark.parametrize("extra", [[], ["--num-experts", "4"]],
                         ids=["dense", "moe"])
def test_cli_prints_the_jax_cli_lines(extra):
    want = _lines(_jax_cli(FLAGS + extra))
    text, out = _port_cli(FLAGS + extra)
    got = _lines(text)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert "mesh={'dp': 1, 'sp': 1, 'tp': 1, 'pp': 1, 'ep': 1}" in text
    assert "generated 8 tokens" in text
    for (kind, g), (_, w) in zip(got, want):
        assert len(g) == len(w), kind
        for a, b in zip(g, w):
            assert abs(a - b) <= 1e-3, (kind, g, w)
    assert out["generated"].shape == (1, 8)
    assert out["loss"] == pytest.approx(want[-2][1][-1], abs=1e-3)
    assert all(p.device.type == "cpu" for p in out["params"].parameters())


@pytest.mark.parametrize("mesh,item", [("2,1,1,1,1", "A13"),
                                       ("1,1,1,1,2", "A15")])
def test_cli_sharded_mesh_raises_naming_its_item(mesh, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["--mesh", mesh, "--steps", "1"], device="cpu")
    with pytest.raises(ValueError, match="--mesh"):
        cli.main(["--mesh", "1,1", "--steps", "1"], device="cpu")
