"""Import hygiene: the port, chip_smoke.py and the probes import no JAX, no
flax, no msgpack (the card's machine is not known to have it) and nothing
of the JAX package -- checked in the source and in a fresh interpreter."""

import ast
import os
import subprocess
import sys

import pytest

import _torch_port_util  # noqa: F401  (caps torch's threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "graphinvent_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "graphinvent_tpu", "msgpack")


def _sources():
    out = [os.path.join(ROOT, name) for name in
           ("chip_smoke.py", "probe_fused_enn.py", "probe_grad_numerics.py",
            "probe_rl_numerics.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def _imported(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_every_sub_package_is_covered():
    dirs = {os.path.dirname(p) for p in _sources()}
    for sub in ("chem", "data", "eval", "models", "rl", "sampling", "tools",
                "train", "utils"):
        assert os.path.join("graphinvent_tpu_torch", sub) in dirs, sub
    # h5py is imported by the storage module alone, and only inside calls
    users = [p for p in _sources() if "h5py" in set(_imported(p))]
    assert users == [os.path.join("graphinvent_tpu_torch", "data",
                                  "store.py")]


@pytest.mark.parametrize("path", _sources())
def test_source_imports_nothing_of_jax(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_fresh_interpreter_loads_no_jax():
    modules = sorted(
        "graphinvent_tpu_torch." + os.path.splitext(p)[0].replace(
            os.sep, ".")[len("graphinvent_tpu_torch."):]
        for p in _sources() if p.startswith("graphinvent_tpu_torch"))
    code = ("import sys, importlib\n"
            f"for m in {modules!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
