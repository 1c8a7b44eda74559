"""Whether the dataset renderer's files repeat, on one CUDA card.

``ops/mesh.py:vertex_normals`` sums each vertex's face normals. CUDA's
``index_add_`` adds with atomics in no fixed order, so on the card a
vertex with three or more terms of one corner slot can get normals a last
bit apart from run to run, and a rendered PNG a step of a u8 channel
apart; ``ordered_vertex_sum``, the sum it takes on every device, adds in
one order. On the port's synthetic fixture (2 subjects, their scans and fits)
rendered at the reference's settings (36 views at 512^2, PRT from 64
directions, visibility at 4096^2), with TF32 off, this prints:

1. how many distinct results ``vertex_normals`` of the first subject's
   scan gives in ``--repeats`` runs, with the sums through ``index_add_``
   and through ``ordered_vertex_sum``;
2. the files of two ``-procs 1`` renders in this process with the sums
   through ``index_add_`` that are not byte-equal, by kind, with the
   largest difference of their decoded values; and the same for a
   ``-procs 1`` and a ``-procs 2`` render with the ordered sums.

Usage, from the repository root on the card:

    python3 -m icon_tpu_torch.data.profile_render_bytes [--repeats 20]
        [--out FILE]
"""

import argparse
import json
import os
import os.path as osp
import subprocess
import tempfile

import numpy as np
import torch

ARGV = ["-dataset", "synth", "-views", "36", "-size", "512", "-prt",
        "-prt_dirs", "64", "-vis_res", "4096"]


def index_add_sum(values, faces, n_verts):
    """The sums as ``vertex_normals`` took them before: ``index_add_`` over
    each corner slot (on the card, in no fixed order)."""
    out = values.new_zeros((values.shape[0], n_verts, values.shape[2]))
    for j in range(3):
        out.index_add_(1, faces[:, j].long(), values)
    return out


def render(src: str, name: str, procs: int) -> dict:
    """The render CLI on ``src``'s scans and fits into a root of its own:
    {relative path: bytes}."""
    from icon_tpu_torch.apps.render import main
    root = osp.join(osp.dirname(src), name)
    os.makedirs(osp.join(root, "synth"))
    for sub in ("scans", "fits"):
        os.symlink(osp.join(src, "synth", sub), osp.join(root, "synth", sub))
    files = {}
    for rec in main(["-root", root, "-procs", str(procs)] + ARGV):
        for dp, _, names in os.walk(rec["out_dir"]):
            for n in names:
                path = osp.join(dp, n)
                with open(path, "rb") as fh:
                    files[osp.relpath(path, osp.dirname(rec["out_dir"]))] = \
                        fh.read()
    return files


def decoded(rel: str, data: bytes) -> np.ndarray:
    import io
    from PIL import Image
    if rel.endswith(".png"):
        return np.asarray(Image.open(io.BytesIO(data)), np.float64)
    if rel.endswith(".npy"):
        return np.load(io.BytesIO(data)).astype(np.float64)
    return np.loadtxt(io.BytesIO(data))


def differ(a: dict, b: dict) -> dict:
    """{kind: [files not byte-equal, largest decoded difference]}."""
    if sorted(a) != sorted(b):
        raise AssertionError("the two renders wrote other files")
    out = {}
    for rel in sorted(a):
        if a[rel] != b[rel]:
            kind = rel.split(os.sep)[1]
            n, worst = out.get(kind, (0, 0.0))
            out[kind] = [n + 1, max(worst, float(np.abs(
                decoded(rel, a[rel]) - decoded(rel, b[rel])).max()))]
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_render_bytes needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from icon_tpu_torch.apps.render import load_subject
    from icon_tpu_torch.data.fixture import make_synthetic_dataset
    from icon_tpu_torch.ops import mesh
    dev = torch.device("cuda", 0)
    ordered = mesh.ordered_vertex_sum
    res = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0], "files": 2 * 36 * 7}
    with tempfile.TemporaryDirectory() as d:
        src = osp.join(d, "data")
        make_synthetic_dataset(src, n_subjects=2, n_views=3, size=512,
                               vis_res=1024, device=dev)
        scan_v, scan_f, _, _ = load_subject(src, "synth", "0000", dev)
        v = torch.as_tensor(scan_v, dtype=torch.float32, device=dev)[None]
        f = torch.as_tensor(scan_f, dtype=torch.int64, device=dev)
        try:
            for name, fn in (("index_add_", index_add_sum),
                             ("ordered", ordered)):
                mesh.ordered_vertex_sum = fn
                runs = {mesh.vertex_normals(v, f).cpu().numpy().tobytes()
                        for _ in range(args.repeats)}
                res[f"distinct normals, {name}"] = len(runs)
            mesh.ordered_vertex_sum = index_add_sum
            res["index_add_: -procs 1 twice"] = differ(
                render(src, "a", 1), render(src, "b", 1))
        finally:
            mesh.ordered_vertex_sum = ordered
        res["ordered: -procs 1 and -procs 2"] = differ(
            render(src, "c", 1), render(src, "e", 2))
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
