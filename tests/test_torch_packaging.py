"""An installed port carries what it builds from and builds inside itself:
every kernel source and header, the token store's C++ source and the eval
JSON tables match a glob of the port's package data in pyproject.toml, and
both build directories lie inside the package, beside their sources.
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
