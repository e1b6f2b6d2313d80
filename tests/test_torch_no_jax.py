"""hpsdf_tpu_torch stands alone: importing it, its mesh package, its
kernel bindings, the sphere tracer, inverse rendering, the continuity solve,
the profiling helpers and sharding loads neither jax
nor hpsdf_tpu, nor does importing the script that drives it on the card
(chip_smoke.py), and no import statement in either names them."""

import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_out_jax_and_hpsdf_tpu():
    code = (
        "import sys\n"
        "import hpsdf_tpu_torch, hpsdf_tpu_torch.mesh, hpsdf_tpu_torch._kernels\n"
        "import hpsdf_tpu_torch.inverse, hpsdf_tpu_torch.render\n"
        "import hpsdf_tpu_torch.continuity, hpsdf_tpu_torch.profiling\n"
        "import hpsdf_tpu_torch.parallel\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'hpsdf_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_SCRIPTS = ("chip_smoke.py", "chip_compare.py")


def test_scripts_leave_out_jax_and_hpsdf_tpu():
    """The script that drives the port on the card imports neither jax nor
    hpsdf_tpu when it loads."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'hpsdf_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_import_of_jax_or_hpsdf_tpu_anywhere():
    """No import statement of the package or of those scripts, at the top
    or inside a function, names jax or hpsdf_tpu."""
    import ast

    pkg = os.path.join(_ROOT, "hpsdf_tpu_torch")
    files = [os.path.join(_ROOT, s) for s in _SCRIPTS]
    for dirpath, _, names in os.walk(pkg):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib",
                                                 "hpsdf_tpu"), (path, mod)
