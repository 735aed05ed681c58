"""Environment documentation generator.

Counterpart of ``minigrid_tpu/tools/gen_docs.py`` (the analogue of the
reference's sphinx doc generators, docs/scripts/gen_mds.py:1-124,
gen_gifs.py:1-80): walks the registry, groups ids by env class, and emits
one markdown page per environment family with its description (class
docstring), registered presets, action space, mission surface, and
optionally a rendered frame PNG and a rollout GIF, rendered by the port's
atlas renderer on a batch of one.

Usage:
    python -m minigrid_tpu_torch.tools.gen_docs --out docs/environments \
        [--images] [--gifs] [--device cuda]

The default ``--out`` is the JAX package's docs directory: run with it, the
tool rewrites those pages from the port's docstrings.
"""

from __future__ import annotations

import argparse
import collections
import os

import numpy as np
import torch


def _frame(env, state, params, **kwargs) -> np.ndarray:
    """Env 0's RGB frame on the host."""
    return env.get_frame(state, params, **kwargs)[0].cpu().numpy()


def gen_gif(env_id: str, path: str, num_frames: int = 48,
            tile_size: int = 16, seed: int = 0, device=None) -> None:
    """Animated GIF of a random-policy rollout for one env id — the
    analogue of the reference's docs/scripts/gen_gifs.py:1-80, rendered by
    the atlas renderer on ``device`` (CUDA unless named)."""
    from PIL import Image

    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.core.state import resolve_device

    dev = resolve_device(device)
    env = minigrid_tpu_torch.make(env_id)
    params = env.default_params
    key = rng.PRNGKey(seed, dev)
    key, k = rng.split(key).unbind(0)
    _, state = env.reset(k[None], params, dev)
    frames = []
    np_rng = np.random.default_rng(seed)
    for _ in range(num_frames):
        frames.append(Image.fromarray(_frame(env, state, params, tile_size=tile_size)))
        a = int(np_rng.integers(0, env.num_actions))
        action = torch.full((1,), a, dtype=torch.int32, device=dev)
        _, state, _, te, tr, _ = env.step(state, action, params)
        if bool(te[0]) or bool(tr[0]):
            key, k = rng.split(key).unbind(0)
            _, state = env.reset(k[None], params, dev)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=100, loop=0)


def build_pages(with_images: bool = False, out_dir: str = "docs/environments",
                seed: int = 0, with_gifs: bool = False,
                device=None) -> dict[str, str]:
    import minigrid_tpu_torch
    from minigrid_tpu_torch.core import rng
    from minigrid_tpu_torch.core.state import resolve_device
    from minigrid_tpu_torch.core.step import Actions
    from minigrid_tpu_torch.registry import spec

    by_cls: dict = collections.defaultdict(list)
    for env_id in minigrid_tpu_torch.registered_ids():
        by_cls[spec(env_id).cls].append(env_id)

    dev = resolve_device(device) if with_images or with_gifs else None
    pages: dict[str, str] = {}
    for cls, ids in sorted(by_cls.items(), key=lambda kv: kv[0].__name__):
        name = cls.__name__
        lines = [f"# {name}", ""]
        doc = (cls.__doc__ or "").strip()
        if doc:
            lines += [doc, ""]

        if with_images:
            img_path = os.path.join(out_dir, "img", f"{name}.png")
            if not os.path.exists(img_path):  # media is content-stable per seed
                env = minigrid_tpu_torch.make(ids[0])
                params = env.default_params
                _, state = env.reset(rng.PRNGKey(seed, dev)[None], params, dev)
                os.makedirs(os.path.dirname(img_path), exist_ok=True)
                _write_png(img_path, _frame(env, state, params))
            lines += [f"![{name}](img/{name}.png)", ""]
        if with_gifs:
            gif_path = os.path.join(out_dir, "gif", f"{name}.gif")
            if not os.path.exists(gif_path):
                gen_gif(ids[0], gif_path, seed=seed, device=dev)
            lines += [f"![{name} rollout](gif/{name}.gif)", ""]

        env = minigrid_tpu_torch.make(ids[0])
        try:
            mission = (env.mission_text(np.asarray(env.mission_codes()[0]))
                       or "(episode-specific)")
        except Exception:
            mission = "(episode-specific)"
        lines += ["## Mission", "", f"`{mission}`", ""]
        lines += ["## Action space", ""]
        lines += [f"| {a.value} | `{a.name}` |" for a in Actions]
        lines.insert(-len(list(Actions)), "|----|--------|")
        lines.insert(-len(list(Actions)) - 1, "| id | action |")
        lines += ["", "## Registered presets", ""]
        lines += ["| id | kwargs |", "|----|--------|"]
        for env_id in sorted(ids):
            kw = spec(env_id).kwargs
            kw_str = ", ".join(f"{k}={v}" for k, v in kw.items()) or "—"
            lines.append(f"| `{env_id}` | {kw_str} |")
        pages[name] = "\n".join(lines) + "\n"
    return pages


def _write_png(path: str, rgb) -> None:
    """Minimal dependency-free PNG writer (uint8 RGB)."""
    import struct
    import zlib

    rgb = np.asarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[0], rgb.shape[1]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="docs/environments")
    p.add_argument("--images", action="store_true")
    p.add_argument("--gifs", action="store_true",
                   help="render an animated random-rollout GIF per family "
                        "(reference docs/scripts/gen_gifs.py)")
    p.add_argument("--device", default=None, help="'cpu' to render on the CPU")
    args = p.parse_args(argv)
    pages = build_pages(with_images=args.images, out_dir=args.out,
                        with_gifs=args.gifs, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    index = ["# Environments", ""]
    for name, content in sorted(pages.items()):
        with open(os.path.join(args.out, f"{name}.md"), "w") as f:
            f.write(content)
        index.append(f"- [{name}]({name}.md)")
    with open(os.path.join(args.out, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print(f"wrote {len(pages)} pages to {args.out}")


if __name__ == "__main__":
    main()
