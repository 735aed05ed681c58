"""Static HTML documentation site builder.

Counterpart of ``minigrid_tpu/tools/gen_site.py``, the analogue of the
reference's sphinx site (docs/conf.py, docs/index.md, docs/Makefile — furo
theme + myst_parser): a dependency-free generator that converts the
markdown pages emitted by :mod:`gen_docs` into a browsable static site —
an index grouped by environment section, one HTML page per family with
the PNG frame / rollout GIF embedded, and a shared stylesheet.  Given the
same markdown, its output is byte for byte the JAX package's (the footer
names that tool), so either package can rebuild the one site.

The markdown dialect handled covers what gen_docs and the hand-written
guide pages (docs/index.md, docs/content/, docs/api/) emit: ATX headings,
pipe tables, fenced code blocks, images, inline code, yaml front matter,
and paragraphs.

Usage:
    python -m minigrid_tpu_torch.tools.gen_site --src docs/environments \
        --out docs/site
"""

from __future__ import annotations

import argparse
import html
import os
import re

_CSS = """\
body { font-family: -apple-system, 'Segoe UI', Roboto, sans-serif;
       max-width: 56rem; margin: 2rem auto; padding: 0 1rem;
       color: #1a1a2e; line-height: 1.55; }
a { color: #0b5fff; text-decoration: none; }
a:hover { text-decoration: underline; }
h1, h2 { border-bottom: 1px solid #e4e4ef; padding-bottom: .25rem; }
code { background: #f2f2f8; border-radius: 4px; padding: .1rem .3rem;
       font-size: .92em; }
table { border-collapse: collapse; margin: 1rem 0; }
td, th { border: 1px solid #d8d8e8; padding: .3rem .7rem; text-align: left; }
th { background: #f6f6fb; }
img { max-width: 100%; image-rendering: pixelated; }
pre { background: #f6f6fb; border: 1px solid #e4e4ef; border-radius: 6px;
      padding: .7rem .9rem; overflow-x: auto; font-size: .88em; }
nav { font-size: .9rem; margin-bottom: 1.5rem; }
.cols { columns: 3 14rem; }
.cols ul { margin: 0 0 1rem; padding-left: 1.2rem; }
footer { margin-top: 3rem; font-size: .8rem; color: #777; }
"""

_INLINE_CODE = re.compile(r"`([^`]+)`")
_IMAGE = re.compile(r"!\[([^\]]*)\]\(([^)]+)\)")
_LINK = re.compile(r"(?<!!)\[([^\]]+)\]\(([^)]+)\)")


def _inline(text: str) -> str:
    """Escape, then rebuild the inline spans gen_docs emits."""
    out = html.escape(text, quote=False)
    out = _IMAGE.sub(lambda m: f'<img alt="{m.group(1)}" src="{m.group(2)}">',
                     out)
    out = _LINK.sub(lambda m: f'<a href="{m.group(2)}">{m.group(1)}</a>', out)
    out = _INLINE_CODE.sub(lambda m: f"<code>{m.group(1)}</code>", out)
    return out


def md_to_html(md: str) -> str:
    """Convert the gen_docs markdown dialect to an HTML body."""
    lines = md.split("\n")
    out: list[str] = []
    i = 0
    # yaml front matter (the guide pages carry a sphinx-style header)
    if lines and lines[0].strip() == "---":
        j = 1
        while j < len(lines) and lines[j].strip() != "---":
            j += 1
        i = j + 1
    while i < len(lines):
        line = lines[i]
        if not line.strip():
            i += 1
            continue
        if line.lstrip().startswith("```"):
            i += 1
            code = []
            while i < len(lines) and not lines[i].lstrip().startswith("```"):
                code.append(lines[i])
                i += 1
            i += 1  # closing fence
            out.append("<pre><code>"
                       + html.escape("\n".join(code), quote=False)
                       + "</code></pre>")
            continue
        m = re.match(r"^(#{1,4})\s+(.*)$", line)
        if m:
            n = len(m.group(1))
            out.append(f"<h{n}>{_inline(m.group(2))}</h{n}>")
            i += 1
            continue
        if line.lstrip().startswith("|"):
            rows = []
            while i < len(lines) and lines[i].lstrip().startswith("|"):
                cells = [c.strip() for c in lines[i].strip().strip("|").split("|")]
                rows.append(cells)
                i += 1
            header, body = rows[0], rows[1:]
            if body and set("".join(body[0])) <= set("-: "):
                body = body[1:]  # separator row
            out.append("<table><thead><tr>"
                       + "".join(f"<th>{_inline(c)}</th>" for c in header)
                       + "</tr></thead><tbody>")
            for r in body:
                out.append("<tr>" + "".join(f"<td>{_inline(c)}</td>"
                                            for c in r) + "</tr>")
            out.append("</tbody></table>")
            continue
        if line.lstrip().startswith(("- ", "* ")):
            out.append("<ul>")
            while i < len(lines) and lines[i].lstrip().startswith(("- ", "* ")):
                out.append(f"<li>{_inline(lines[i].lstrip()[2:])}</li>")
                i += 1
            out.append("</ul>")
            continue
        # paragraph: consume until blank / structural line
        para = []
        while (i < len(lines) and lines[i].strip()
               and not lines[i].lstrip().startswith(("#", "|", "- ", "* "))):
            para.append(lines[i])
            i += 1
        out.append(f"<p>{_inline(' '.join(para))}</p>")
    return "\n".join(out)


def _page(title: str, body: str, root: str = "") -> str:
    return (f"<!doctype html><html lang=\"en\"><head><meta charset=\"utf-8\">"
            f"<meta name=\"viewport\" content=\"width=device-width\">"
            f"<title>{html.escape(title)}</title>"
            f"<link rel=\"stylesheet\" href=\"{root}style.css\"></head><body>"
            f"<nav><a href=\"{root}index.html\">minigrid-tpu docs</a></nav>"
            f"{body}<footer>generated by minigrid_tpu.tools.gen_site — the "
            f"sphinx-site analogue (reference docs/conf.py)</footer>"
            f"</body></html>\n")


def _section_of(ids: list[str]) -> str:
    if any(i.startswith("BabyAI-") for i in ids):
        return "BabyAI"
    if any(("Dataset" in i) or i.startswith(("Negated", "Contrastive",
                                             "Directions", "Blocks"))
           for i in ids):
        return "Datasets"
    return "MiniGrid"


def build_site(src: str = "docs/environments", out: str = "docs/site") -> int:
    """Render every markdown page under `src` to HTML under `out`; returns
    the page count.  Media directories (img/, gif/) are referenced
    relatively, via a symlink when possible and a copy otherwise."""
    import shutil

    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "style.css"), "w") as f:
        f.write(_CSS)

    # media passthrough
    for media in ("img", "gif"):
        sdir = os.path.join(src, media)
        ddir = os.path.join(out, media)
        if os.path.isdir(sdir) and not os.path.exists(ddir):
            try:
                os.symlink(os.path.relpath(sdir, out), ddir)
            except OSError:
                shutil.copytree(sdir, ddir)

    from minigrid_tpu_torch.registry import registered_ids, spec

    by_cls: dict[str, list[str]] = {}
    for env_id in registered_ids():
        by_cls.setdefault(spec(env_id).cls.__name__, []).append(env_id)

    sections: dict[str, list[str]] = {"MiniGrid": [], "BabyAI": [],
                                      "Datasets": []}
    count = 0
    for fname in sorted(os.listdir(src)):
        if not fname.endswith(".md") or fname == "index.md":
            continue
        name = fname[:-3]
        with open(os.path.join(src, fname)) as f:
            body = md_to_html(f.read())
        with open(os.path.join(out, f"{name}.html"), "w") as f:
            f.write(_page(name, body))
        sections.setdefault(_section_of(by_cls.get(name, [])), []).append(name)
        count += 1

    # guide pages (docs/index.md + content/ + api/) — the reference's
    # sphinx content/api layer rendered into the same site
    docs_root = os.path.dirname(os.path.abspath(src))
    guides: list[tuple[str, str]] = []
    guide_srcs = [("index.md", "guide_overview", "Overview")]
    for sub in ("content", "api"):
        d = os.path.join(docs_root, sub)
        if os.path.isdir(d):
            for fname in sorted(os.listdir(d)):
                if fname.endswith(".md"):
                    title = fname[:-3].replace("_", " ").title()
                    guide_srcs.append((os.path.join(sub, fname),
                                       f"guide_{sub}_{fname[:-3]}", title))
    for rel, out_name, title in guide_srcs:
        path = os.path.join(docs_root, rel)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            body = md_to_html(f.read())
        with open(os.path.join(out, f"{out_name}.html"), "w") as f:
            f.write(_page(title, body))
        guides.append((out_name, title))
        count += 1

    parts = []
    if guides:
        parts.append("<h1>Guides</h1><div class=\"cols\"><ul>")
        parts += [f'<li><a href="{n}.html">{t}</a></li>' for n, t in guides]
        parts.append("</ul></div>")
    parts.append("<h1>Environments</h1>")
    for sec in ("MiniGrid", "BabyAI", "Datasets"):
        names = sections.get(sec) or []
        if not names:
            continue
        parts.append(f"<h2>{sec}</h2><div class=\"cols\"><ul>")
        parts += [f'<li><a href="{n}.html">{n}</a></li>' for n in names]
        parts.append("</ul></div>")
    with open(os.path.join(out, "index.html"), "w") as f:
        f.write(_page("minigrid-tpu environments", "\n".join(parts)))
    return count


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--src", default="docs/environments")
    p.add_argument("--out", default="docs/site")
    args = p.parse_args()
    n = build_site(args.src, args.out)
    print(f"wrote {n} pages to {args.out}")


if __name__ == "__main__":
    main()
