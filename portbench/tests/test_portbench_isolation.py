"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level names; the reference imports nothing of the port."""
import ast
import subprocess
import sys
import types

import torch

from portbench import harness, spec
from portbench.drivers import mesh_fit

REFERENCE = spec.HERE / "reference"


def test_whole_name_check(monkeypatch):
    assert "awesome_tpu_torch" not in harness.FORBIDDEN
    monkeypatch.setitem(sys.modules, "awesome_tpu_torch_like",
                        types.ModuleType("awesome_tpu_torch_like"))
    monkeypatch.setitem(sys.modules, "jaxtyping",
                        types.ModuleType("jaxtyping"))
    assert "awesome_tpu" not in harness.forbidden_modules()
    assert "jax" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "awesome_tpu.nn",
                        types.ModuleType("awesome_tpu.nn"))
    assert "awesome_tpu" in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_port():
    files = sorted(REFERENCE.glob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("torch", "portbench", "__future__", "typing",
                           "math"), (path.name, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), name


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU, then the loaded modules."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from portbench import harness, spec\n"
        "b = spec.benchmark()\n"
        "for name in [c['name'] for c in b['workloads']]:\n"
        "    cell = spec.cell(b, name)\n"
        "    cfg = dict(spec.config(cell['config']), num_steps=3,"
        " warm_steps=3)\n"
        "    trf = dict(spec.traffic(cell['traffic']), height=16, width=16,"
        " images=2)\n"
        "    rec = harness.run_cell(cell, cfg, trf, spec.limits(name), 7,"
        " 0.0, False, 'cpu')\n"
        "    assert rec['forbidden'] == [], (name, rec['forbidden'])\n"
        "print(harness.forbidden_modules())\n"
        "print('reference' , sorted(m for m in sys.modules"
        " if m.startswith('portbench.reference')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-2] == "[]"


def test_reference_alone_loads_no_port():
    code = ("import sys\n"
            "import portbench.reference.fit, portbench.reference.joint\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'awesome_tpu_torch', 'awesome_tpu', 'jax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def planting_rank(ctx, seconds, trace, start_wall):
    """A mesh rank that loads a module of the JAX package, as a port that
    imported it would, then runs as any rank (module level: the spawned
    ranks import it)."""
    sys.modules["awesome_tpu.nn"] = types.ModuleType("awesome_tpu.nn")
    return mesh_fit.rank_main(ctx, seconds, trace, start_wall)


def test_a_mesh_rank_that_loads_the_jax_package_fails_the_run(
        monkeypatch, capsys):
    """The mesh cell's window runs in ranks of their own: one that loads
    ``awesome_tpu`` makes the run exit 4 and print no result. The run is
    ``main``'s, past its look for cards, at a tiny size on 4 gloo ranks."""
    cell = "fbms_pc.mesh_1x4_480x640"

    def tiny_cpu_run(entry, config, traffic, limits, seed, seconds, trace,
                     device, t_start):
        return harness.run_cell(
            entry, dict(config, num_steps=3),
            dict(traffic, height=16, width=16), limits, seed, seconds,
            trace, "cpu", t_start)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(mesh_fit, "rank_main", planting_rank)
    rc = harness.main(["--workload", cell, "--seed", "5", "--seconds", "0",
                       "--trace", "0"], run=tiny_cpu_run)
    out, err = capsys.readouterr()
    assert rc == 4
    assert "awesome_tpu" in err
    assert out == ""
