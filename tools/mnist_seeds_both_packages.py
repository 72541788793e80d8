"""train_mnist's MLP at its default flags (lr 0.3, momentum 0.9, 6
epochs) in both packages on the CPU over shuffle seeds: does it
collapse to chance, and on the same seeds?

For each ``np.random`` seed (which fixes ``NDArrayIter``'s shuffle in
both packages) each CLI is run twice: with its own weight init (each
package's own generator, so a seed is a different run in each), and
with the shared init of ``tests/test_torch_train_mnist_cli.py`` (the
``Uniform`` draw patched to a numpy draw seeded by the parameter's
name), where a seed is the same run in both up to float32 rounding.
Prints one line a run: package, init, seed, the final validation
accuracy (near 0.1, chance, where the run collapsed).

    JAX_PLATFORMS=cpu python tools/mnist_seeds_both_packages.py [--seeds 8]
"""
import argparse
import contextlib
import importlib.util
import io
import logging
import os
import re
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _seeded_uniform(mx):
    def _init_weight(self, name, arr):
        value = np.random.RandomState(zlib.crc32(str(name).encode())) \
            .uniform(-self.scale, self.scale, arr.shape)
        arr[:] = mx.nd.array(value.astype(np.float32), ctx=arr.context)
    return _init_weight


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "_jax_train_mnist", os.path.join(ROOT, "examples", "train_mnist.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(package, shared, seed):
    """The final validation accuracy of one MLP run, as printed."""
    if package == "jax":
        import mxnet_tpu as mx
        from mxnet_tpu.symbol.symbol import _name_mgr
        cli = _jax_cli()
    else:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.examples import train_mnist as cli
        from mxnet_tpu_torch.symbol.symbol import _name_mgr
    saved = mx.init.Uniform._init_weight
    if shared:
        mx.init.Uniform._init_weight = _seeded_uniform(mx)
    _name_mgr._counter = {}
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            np.random.seed(seed)
            if package == "jax":
                sys.argv = ["train_mnist.py", "--network", "mlp"]
                cli.main()
            else:
                cli.main(["--network", "mlp", "--gpus", ""])
    finally:
        mx.init.Uniform._init_weight = saved
    m = re.search(r"final validation accuracy: ([0-9.]+)", out.getvalue())
    return m.group(1) if m else None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    logging.disable(logging.CRITICAL)
    for shared in (False, True):
        for package in ("jax", "port"):
            for seed in range(args.seeds):
                print("%-4s init=%-6s seed %d final validation accuracy %s"
                      % (package, "shared" if shared else "own", seed,
                         run(package, shared, seed)), flush=True)


if __name__ == "__main__":
    main()
