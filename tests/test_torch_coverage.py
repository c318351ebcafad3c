"""Every public top-level name of the JAX package has a counterpart in the
port.

Each module of ``torch_fdtd_string_tpu/`` is parsed with ``ast``; every
function, class and assigned name it defines at top level that does not
start with ``_`` must be defined or imported at top level by the port's
module of the same path (``ops/pallas_step.py``'s by
``ops/string_kernel.py``), or stand on the allow-list below with its
reason.  A module the port lacks fails too.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "torch_fdtd_string_tpu")
PORT_PKG = os.path.join(ROOT, "torch_fdtd_string_tpu_torch")
SAME_PLACE = {"ops/pallas_step.py": "ops/string_kernel.py"}

NOT_PORTED = {
    ("tasks/simulate.py", "link_bytes"):
        "ported as RunStats.link_bytes (tasks/simulate.py), one run's counters",
    ("tasks/simulate.py", "save_timing"):
        "ported as RunStats.save_timing (tasks/simulate.py), one run's writer timings",
    ("parallel/mesh.py", "make_mesh"):
        "a jax.sharding.Mesh; the ranks of the port's torch.distributed group take its place",
    ("parallel/mesh.py", "DATA_AXIS"):
        "the mesh's axis name; the port's group has no named axes",
    ("models/optim.py", "jnp_maximum"):
        "a jnp wrapper for the noam schedule; the port computes schedules in float64 Python",
    ("models/optim.py", "jnp_minimum"):
        "a jnp wrapper for the noam schedule; the port computes schedules in float64 Python",
}


def _modules():
    out = []
    for d, dirs, files in os.walk(JAX_PKG):
        dirs[:] = sorted(x for x in dirs if x not in ("configs", "__pycache__"))
        out += sorted(os.path.relpath(os.path.join(d, f), JAX_PKG)
                      for f in files if f.endswith(".py"))
    return out


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read(), path)


def defined(path):
    """The names a module defines at top level: functions, classes and
    assignment targets."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                names.update(e.id for e in ast.walk(t) if isinstance(e, ast.Name))
    return names


def bound(path):
    """The names a module binds at top level: what it defines and imports."""
    names = defined(path)
    for node in _tree(path).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return names


def test_the_audit_reads_every_module():
    mods = _modules()
    assert "ops/pallas_step.py" in mods and "tasks/trainer.py" in mods
    assert len(mods) > 40


@pytest.mark.parametrize("rel", _modules())
def test_every_public_name_has_a_counterpart(rel):
    port = os.path.join(PORT_PKG, SAME_PLACE.get(rel, rel))
    assert os.path.isfile(port), f"the port has no {SAME_PLACE.get(rel, rel)}"
    have = bound(port)
    missing = sorted(n for n in defined(os.path.join(JAX_PKG, rel))
                     if not n.startswith("_") and n not in have
                     and (rel, n) not in NOT_PORTED)
    assert not missing, f"{rel}: {missing}"


@pytest.mark.parametrize("entry", sorted(NOT_PORTED), ids=lambda e: f"{e[0]}:{e[1]}")
def test_the_allow_list_names_real_gaps(entry):
    """Each allowed name is defined by its JAX module and still absent
    from the port's, so that the list shrinks when one is ported."""
    rel, name = entry
    assert name in defined(os.path.join(JAX_PKG, rel))
    assert name not in bound(os.path.join(PORT_PKG, SAME_PLACE.get(rel, rel)))
