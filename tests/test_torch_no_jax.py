"""hpsdf_tpu_torch stands alone: importing it, its mesh package, its
kernel bindings, the sphere tracer and inverse rendering loads neither jax
nor hpsdf_tpu."""

import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_out_jax_and_hpsdf_tpu():
    code = (
        "import sys\n"
        "import hpsdf_tpu_torch, hpsdf_tpu_torch.mesh, hpsdf_tpu_torch._kernels\n"
        "import hpsdf_tpu_torch.inverse, hpsdf_tpu_torch.render\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'hpsdf_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
