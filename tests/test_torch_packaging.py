"""The port's kernel sources ship in the package: every file a ``.cu`` or
``.cuh`` in ``minigrid_tpu_torch/csrc`` includes by a quoted name must be
matched by a ``minigrid_tpu_torch`` package-data glob of ``pyproject.toml``,
or an installed (non-editable) port cannot build its kernels."""

from __future__ import annotations

import fnmatch
import re
import tomllib
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "minigrid_tpu_torch" / "csrc"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _package_globs() -> list[str]:
    with open(ROOT / "pyproject.toml", "rb") as f:
        config = tomllib.load(f)
    return config["tool"]["setuptools"]["package-data"]["minigrid_tpu_torch"]


def _shipped(path: Path, globs: list[str]) -> bool:
    rel = path.relative_to(ROOT / "minigrid_tpu_torch").as_posix()
    return any(fnmatch.fnmatchcase(rel, g) for g in globs)


def test_every_quoted_include_of_csrc_ships():
    globs = _package_globs()
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    assert sources
    included = set()
    for src in sources:
        assert _shipped(src, globs), f"{src.name} is not package data"
        for name in _INCLUDE.findall(src.read_text()):
            header = (src.parent / name).resolve()
            assert header.is_file(), f"{src.name} includes a missing {name}"
            assert _shipped(header, globs), f"{src.name} includes {name}, not shipped"
            included.add(header.name)
    # the kernels share their view tile through a header
    assert "view_tile.cuh" in included


def test_the_check_sees_a_missing_glob():
    """Without the header glob the header is not shipped."""
    header = CSRC / "view_tile.cuh"
    assert _shipped(header, _package_globs())
    assert not _shipped(header, ["csrc/*.cu"])
