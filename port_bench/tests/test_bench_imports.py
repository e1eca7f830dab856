"""What the benchmark loads: no JAX, no JAX package, and a reference that
owes nothing to the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import textwrap

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "ivid_tpu")


def _run(code: str) -> str:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_drivers_load_no_jax():
    """Importing the harness and running both drivers on the CPU at a tiny
    size loads no module whose top-level name is jax, jaxlib, flax or
    ivid_tpu (compared whole: ivid_tpu_torch is the program)."""
    top = _run("""
        import sys
        sys.path.insert(0, "port_bench/tests")
        from conftest import CpuRun
        from port_bench import run
        from port_bench.drivers import sample, train
        sample.run(CpuRun("sc128.sample.random_b1"))
        train.run(CpuRun("sc128.train.inpaint_b8"))
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    loaded = set(ast.literal_eval(top))
    assert "ivid_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    top = _run("""
        import pkgutil, importlib, sys
        import port_bench.reference as ref
        for m in pkgutil.iter_modules(ref.__path__):
            importlib.import_module("port_bench.reference." + m.name)
        print(sorted({m.split(".")[0] for m in sys.modules}))
    """)
    loaded = set(ast.literal_eval(top))
    assert not loaded & {"ivid_tpu_torch", *FORBIDDEN}


def test_reference_sources_name_no_program_module():
    folder = os.path.join(ROOT, "port_bench", "reference")
    for name in os.listdir(folder):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(folder, name)).read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for mod in mods:
                assert mod.split(".")[0] not in ("ivid_tpu_torch", *FORBIDDEN), (name, mod)


def test_forbidden_modules_compare_whole_names():
    from port_bench import run

    sys.modules.setdefault("ivid_tpu_torch_probe", sys)
    try:
        assert "ivid_tpu_torch_probe" not in run.forbidden_modules()
    finally:
        del sys.modules["ivid_tpu_torch_probe"]
