"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the port.  Names are compared by their
top-level part whole: the port's name begins with the JAX package's."""

import ast

import pytest

from benchmark import harness, spec

JAX_NAMES = {"jax", "jaxlib", "flax", "image_restoration_sde_tpu"}
PORT = "image_restoration_sde_tpu_torch"


def imported_top_names(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".", 1)[0])
    return names


SOURCES = sorted(spec.BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_top_names(path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    names = imported_top_names(path)
    assert PORT not in names
    assert names <= {"__future__", "copy", "math", "typing", "numpy", "torch", "benchmark"}


def test_the_port_is_not_the_jax_package():
    assert harness.forbidden_modules(["image_restoration_sde_tpu_torch", "image_restoration_sde_tpu_torch.ops",
                                      "torch", "numpy"]) == []
    assert harness.forbidden_modules(["image_restoration_sde_tpu.sde", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "image_restoration_sde_tpu", "jax", "jaxlib"]


def test_the_scan_sees_each_form_of_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom image_restoration_sde_tpu import sde\n"
                 "from image_restoration_sde_tpu_torch import ops\n__import__('flax')\nfrom . import x\n")
    assert imported_top_names(f) == {"jax", "image_restoration_sde_tpu", "image_restoration_sde_tpu_torch", "flax"}
