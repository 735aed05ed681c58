"""The port's documentation tools (``tools/gen_docs.py``,
``tools/gen_site.py``) against the JAX package's, on the CPU.

A page's description paragraph is its family's class docstring, which the
two packages word differently; everything else on a page (family names, ids
and their kwargs, the action table, the mission) is held equal.  The
renderer is bitwise JAX's, so the PNG frames and the GIF are equal byte for
byte, and the site builder's HTML is byte for byte JAX's on the same
markdown.  Everything is written into ``tmp_path``, never into ``docs/``.
"""

from __future__ import annotations

import collections
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import minigrid_tpu
from minigrid_tpu.tools import gen_docs as jdocs
from minigrid_tpu.tools import gen_site as jsite

from minigrid_tpu_torch.registry import registered_ids, spec
from minigrid_tpu_torch.tools import gen_docs, gen_site

from tests.test_torch_bridge import yield_cpu  # noqa: F401  (yields the CPU under xdist)

# one MiniGrid, one BabyAI and one dataset family
IMAGE_FAMILIES = ("DoorKeyEnv", "GoToRedBallGrey", "BlocksDataset")


def family_ids() -> dict[str, list[str]]:
    by_cls = collections.defaultdict(list)
    for env_id in registered_ids():
        by_cls[spec(env_id).cls.__name__].append(env_id)
    return by_cls


def without_description(page: str) -> str:
    """A page less the description paragraph between its title and its first
    section (or image)."""
    lines = page.split("\n")
    body = next(i for i, line in enumerate(lines)
                if line.startswith(("## ", "![")))
    return "\n".join(lines[:2] + lines[body:])


def test_pages_match_jax_but_the_description():
    got, want = gen_docs.build_pages(), jdocs.build_pages()
    assert set(got) == set(want) and len(got) == 72
    ids = family_ids()
    for name, page in got.items():
        assert without_description(page) == without_description(want[name]), name
        doc = (spec(ids[name][0]).cls.__doc__ or "").strip()
        assert page.startswith(f"# {name}\n\n{doc}\n\n" if doc else f"# {name}\n\n##"), name
    assert "MiniGrid-DoorKey-8x8-v0" in got["DoorKeyEnv"]
    assert "## Action space" in got["EmptyEnv"]


def test_png_frames_match_jax(tmp_path):
    ids = family_ids()
    img = tmp_path / "port" / "img"
    img.mkdir(parents=True)
    # every other family's frame is already there, so only these three render
    for name in ids:
        if name not in IMAGE_FAMILIES:
            (img / f"{name}.png").write_bytes(b"")
    pages = gen_docs.build_pages(with_images=True, out_dir=str(tmp_path / "port"),
                                 device="cpu")
    for name in IMAGE_FAMILIES:
        assert f"![{name}](img/{name}.png)" in pages[name]
        env = minigrid_tpu.make(ids[name][0])
        params = env.default_params
        frame = jax.jit(lambda k: env.get_frame(env.reset(k, params)[1], params))(
            jax.random.PRNGKey(0))
        want = tmp_path / f"{name}.png"
        jdocs._write_png(str(want), np.asarray(frame))
        assert (img / f"{name}.png").read_bytes() == want.read_bytes(), name


def test_gif_matches_jax(tmp_path):
    from PIL import Image

    got, want = tmp_path / "port.gif", tmp_path / "jax.gif"
    gen_docs.gen_gif("MiniGrid-Empty-5x5-v0", str(got), num_frames=6, tile_size=8,
                     device="cpu")
    jdocs.gen_gif("MiniGrid-Empty-5x5-v0", str(want), num_frames=6, tile_size=8)
    assert got.read_bytes() == want.read_bytes()
    img = Image.open(got)
    assert img.format == "GIF" and getattr(img, "n_frames", 1) >= 2
    assert img.size == (40, 40)  # 5 cells x 8 px


def test_gen_docs_main_writes_pages_and_index(tmp_path, capsys):
    out = tmp_path / "environments"
    gen_docs.main(["--out", str(out)])
    assert "wrote 72 pages" in capsys.readouterr().out
    pages = gen_docs.build_pages()
    for name, page in pages.items():
        assert (out / f"{name}.md").read_text() == page
    index = (out / "index.md").read_text().splitlines()
    assert index[:2] == ["# Environments", ""] and len(index) == 74


def test_media_needs_a_device_and_pages_do_not(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert len(gen_docs.build_pages()) == 72
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen_docs.build_pages(with_images=True, out_dir=str(tmp_path))


def _site_source(root: Path) -> Path:
    """A docs tree: generated family pages, the hand-written pages of the
    JAX package's site test, a guide index with front matter and a content
    page with a code fence, and an image directory."""
    src = root / "environments"
    (src / "img").mkdir(parents=True)
    (src / "img" / "GoTo.png").write_bytes(b"png")
    pages = gen_docs.build_pages()
    for name in ("EmptyEnv", "GoToRedBall", "BlocksDataset", "NegatedSimple"):
        (src / f"{name}.md").write_text(pages[name])
    (src / "DoorKeyEnv.md").write_text(
        "# DoorKeyEnv\n\nA demo env.\n\n## Registered presets\n\n"
        "| id | kwargs |\n|----|--------|\n"
        "| `MiniGrid-DoorKey-8x8-v0` | size=8 |\n")
    (src / "GoTo.md").write_text("# GoTo\n\n![GoTo](img/GoTo.png)\n")
    (src / "Escaped.md").write_text("# Escaped\n\nhello <script>alert(1)</script> & "
                                    "[a link](x.html) `a < b`\n\n- one\n- two\n")
    (src / "index.md").write_text("# skipped: the environments index\n")
    (root / "index.md").write_text("---\ntitle: x\n---\n# Overview\n\nIntro.\n")
    (root / "content").mkdir()
    (root / "content" / "basic_usage.md").write_text(
        "# Basic usage\n\n```python\nx = 1 < 2\n```\n\n#### small\n")
    return src


def _tree(root: Path) -> dict[str, bytes | str]:
    out = {}
    for path in sorted(root.rglob("*")):
        rel = str(path.relative_to(root))
        if path.is_symlink():
            out[rel] = "-> " + os.readlink(path)
        elif path.is_file():
            out[rel] = path.read_bytes()
    return out


def test_site_is_byte_for_byte_jax_s(tmp_path):
    src = _site_source(tmp_path / "docs")
    n = gen_site.build_site(str(src), str(tmp_path / "port"))
    assert n == jsite.build_site(str(src), str(tmp_path / "jax")) == 9
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert set(got) == set(want)
    for rel in want:
        assert got[rel] == want[rel], rel
    index = (tmp_path / "port" / "index.html").read_text()
    for name in ("EmptyEnv", "GoToRedBall", "BlocksDataset", "DoorKeyEnv", "GoTo"):
        assert f"{name}.html" in index
    assert "<h2>BabyAI</h2>" in index and "<h2>Datasets</h2>" in index
    assert "guide_content_basic_usage.html" in index
    page = (tmp_path / "port" / "DoorKeyEnv.html").read_text()
    assert "<h1>DoorKeyEnv</h1>" in page
    assert "<table>" in page and "<code>MiniGrid-DoorKey-8x8-v0</code>" in page
    assert '<img alt="GoTo" src="img/GoTo.png">' in (tmp_path / "port" / "GoTo.html").read_text()
    assert "<script>" not in (tmp_path / "port" / "Escaped.html").read_text()
    assert "<script>" not in gen_site.md_to_html("hello <script>alert(1)</script>")
