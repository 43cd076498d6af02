"""An installed port carries what it builds from and builds inside itself:
every kernel source and header, the token store's C++ source and the eval
JSON tables match a glob of the port's package data in pyproject.toml, and
both build directories lie inside the package, beside their sources. Neither
the port nor chip_smoke.py imports anything of JAX or of grasp_tpu.
"""

import fnmatch
import os
import tomllib
from pathlib import Path

from grasp_tpu_torch.native import bindings
from grasp_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "grasp_tpu_torch"


def test_package_data_ships_every_source_the_port_reads():
    with open(ROOT / "pyproject.toml", "rb") as f:
        project = tomllib.load(f)
    globs = project["tool"]["setuptools"]["package-data"]["grasp_tpu_torch"]
    needed = sorted(str(p.relative_to(PACKAGE)) for p in (
        *(PACKAGE / "csrc").iterdir(), PACKAGE / "native" / "tokenstore.cc",
        *(PACKAGE / "eval").glob("*.json")) if p.is_file())
    assert {"csrc/tensor_core.cuh", "native/tokenstore.cc", "eval/task_specs.json",
            "eval/longbench_tasks.json"} <= set(needed)
    missing = [n for n in needed if not any(fnmatch.fnmatch(n, g) for g in globs)]
    assert not missing, f"not shipped by {globs}: {missing}"
    assert project["project"]["scripts"]["grasp-evaluate-torch"] == \
        "grasp_tpu_torch.cli:evaluate_main"


def test_build_directories_lie_inside_the_package():
    for build_dir, source in ((_build.BUILD_DIR, _build.CSRC_DIR), (bindings.BUILD_DIR,
                                                                     bindings.SOURCE)):
        assert build_dir.is_relative_to(PACKAGE) and source.is_relative_to(PACKAGE)
        assert build_dir.parent == PACKAGE / "build"
        # .gitignore's build/ pattern keeps what is built out of the repository
        assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert os.path.commonpath([_build.library_path(), PACKAGE]) == str(PACKAGE)
    assert os.path.commonpath([bindings.library_path(), PACKAGE]) == str(PACKAGE)


def _imported_roots(path: Path):
    """The top-level package of every import statement in a source file."""
    import ast

    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_port_and_chip_smoke_import_nothing_of_jax():
    """chip_smoke.py and every module of the port: no import of jax, jaxlib,
    flax, optax or grasp_tpu, at any depth of the file."""
    banned = {"jax", "jaxlib", "flax", "optax", "grasp_tpu"}
    files = [ROOT / "chip_smoke.py", *PACKAGE.rglob("*.py")]
    assert len(files) > 20 and PACKAGE / "serving" / "guided.py" in files
    for path in files:
        assert not _imported_roots(path) & banned, path
