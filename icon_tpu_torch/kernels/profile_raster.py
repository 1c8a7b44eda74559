"""The raster backward against the plain version on the fit frame's cloth
meshes, on one CUDA card.

``chip_smoke.py``'s phase 9 holds the raster kernels to the plain version
on one cloth mesh a run, and the cloth loop's meshes differ from run to
run (its gradients are summed by atomics). This runs phase 9's fit frame
(bench.py's config, the subdiv-5 body, 512^2, res 256, TF32 off) ``--fits``
times and its cloth loop ``--cloths`` times a fit, and rasterizes each
refined mesh from azimuth 180 (phase 9's cloth check) and 0 at 512^2
K=256 with its vertex normals. For each raster: the gradient of phase 9's
seeded weighted sum of the images through the kernels and through the
plain version, their gap relative to the largest plain gradient, and each
one's gap to the plain version in float64 (whose inside tests and minima
may fall otherwise than float32's). The three meshes with the widest gap
are written to ``--save`` as .npz. Given ``--meshes``, only those
are compared, and ``raster_bwd`` alone is timed on each (the median of 5
CUDA-event timings of 20 launches behind a device sleep).

    python3 -m icon_tpu_torch.kernels.profile_raster --fits 2 --cloths 12 \\
        --save DIR
    python3 -m icon_tpu_torch.kernels.profile_raster --meshes DIR/*.npz
"""

import argparse
import os
import os.path as osp
import statistics
import time

import numpy as np
import torch

SIZE, K = 512, 256
KEEP = 3                # meshes written to --save


def normal_inputs(verts, faces, azimuth):
    """(ndc, faces, the vertex normals in the view frame): the cloth
    loop's ``render_normal`` raster inputs."""
    from icon_tpu_torch.ops.mesh import vertex_normals
    from icon_tpu_torch.render.camera import verts_to_ndc, view_matrix
    R = torch.as_tensor(view_matrix(azimuth), dtype=verts.dtype,
                        device=verts.device)
    return (verts_to_ndc(verts, azimuth), faces,
            vertex_normals(verts[None], faces)[0] @ R.T)


def phase9_weights(azimuth, dev):
    """Phase 9's weights of the (attr, depth, silhouette) images for the
    cloth raster at ``azimuth``: the second draw of RandomState(11) at 0,
    the third at 180."""
    rng = np.random.RandomState(11)
    for _ in range(2 if azimuth == 0 else 3):
        w = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
             for s in ((SIZE, SIZE, 3), (SIZE, SIZE), (SIZE, SIZE))]
    return w


def _grads(fn, ndc, faces, attrs, weights):
    x = ndc.detach().clone().requires_grad_(True)
    a = attrs.detach().clone().requires_grad_(True)
    out = fn(x, faces, a, H=SIZE, W=SIZE, K=K)
    w = [t.to(x.dtype) for t in weights]
    loss = (out.attr * w[0]).sum() + (out.depth * out.mask * w[1]).sum() + \
        (out.silhouette * w[2]).sum()
    return out, torch.autograd.grad(loss, (x, a))


def compare(ndc, faces, attrs, weights) -> dict:
    """The kernels' gradients against the plain version's (``rel``: the
    largest gap over the largest plain gradient) and both against the
    plain version in float64 (``kernel64``, ``plain64``; ``flips64``: the
    pixels whose face differs in float64)."""
    from icon_tpu_torch.ops.raster import rasterize, rasterize_plain
    out, gk = _grads(rasterize, ndc, faces, attrs, weights)
    ref, gp = _grads(rasterize_plain, ndc, faces, attrs, weights)
    o64, g64 = _grads(rasterize_plain, ndc.double(), faces, attrs.double(),
                      weights)

    def gap(a, b):
        return max(float((x.double() - y.double()).abs().max()) /
                   float(y.abs().max()) for x, y in zip(a, b))

    return {"rel": gap(gk, gp), "kernel64": gap(gk, g64),
            "plain64": gap(gp, g64),
            "pix_to_face_differs": int((out.pix_to_face !=
                                        ref.pix_to_face).sum()),
            "flips64": int((o64.pix_to_face != ref.pix_to_face).sum())}


def bwd_ms(ndc, faces, attrs, weights, reps: int = 20) -> float:
    """``raster_bwd`` alone on this input: its launch on the buffers the
    kernels' forward saved, into preallocated gradients."""
    from icon_tpu_torch.kernels import raster as rk
    out = rk.rasterize(ndc.detach().clone().requires_grad_(True), faces,
                       attrs.detach().clone().requires_grad_(True),
                       SIZE, SIZE, K=K)
    node = out[0].grad_fn
    f, a, slot, lists, counts, win, logsum = node.saved_tensors
    V, H, W, K_, S, R, kz = node.shape
    C = a.shape[1]
    gv = torch.zeros((V, 3), device=a.device)
    ga = torch.zeros_like(a)
    g = [t.contiguous() for t in weights]
    lib = rk._load()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.icon_raster_bwd(
            lists.data_ptr(), counts.data_ptr(), slot.data_ptr(),
            f.shape[0], f.data_ptr(), a.data_ptr(), K_, R, S, C, H, W, kz,
            g[0].data_ptr(), g[1].data_ptr(), g[2].data_ptr(),
            win.data_ptr(), logsum.data_ptr(), gv.data_ptr(), ga.data_ptr(),
            stream)
        if err:
            raise RuntimeError(f"raster_bwd launch failed ({err})")

    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def saved_meshes(paths, dev):
    for path in paths:
        z = np.load(path)
        yield (osp.basename(path), torch.tensor(z["verts"], device=dev),
               torch.tensor(z["faces"], dtype=torch.int64, device=dev),
               float(z["az"]))


def cloth_meshes(fits, cloths, dev):
    """(name, refined verts, faces, azimuth) of phase 9's cloth loop."""
    from icon_tpu_torch.models.smplx.body import synthetic_smplx_model
    from icon_tpu_torch.recon.frame import (bench_config, build_fit_frame,
                                            seeded_state, variant_occ)
    from icon_tpu_torch.utils.synthetic import synthetic_fit_item
    cfg = bench_config()
    body = synthetic_smplx_model(subdiv=5)
    fr = build_fit_frame(cfg, seeded_state(cfg, 0, normal_net=True), body,
                         256, dev, field=variant_occ)
    item = synthetic_fit_item(fr.body, SIZE, seed=0)
    image = torch.from_numpy(item["image"]).to(dev)
    calib = torch.from_numpy(item["calib"]).to(dev)
    for i in range(fits):
        fit = fr.fit(item)
        verts, faces, _ = fr.recon(image, fit, calib)
        rverts, rfaces = fr.remesh(verts, faces)
        faces_t = torch.as_tensor(rfaces, device=dev)
        for j in range(cloths):
            refined, _ = fr.cloth(rverts, rfaces, fit)
            for az in (180.0, 0.0):
                yield f"fit{i}_cloth{j}_az{int(az)}", refined.detach(), \
                    faces_t, az


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fits", type=int, default=1)
    ap.add_argument("--cloths", type=int, default=12)
    ap.add_argument("--save", default=None)
    ap.add_argument("--meshes", nargs="*", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_raster: needs a CUDA card")
    from icon_tpu_torch.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    dev = torch.device("cuda", 0)
    meshes = saved_meshes(args.meshes, dev) if args.meshes else \
        cloth_meshes(args.fits, args.cloths, dev)
    kept, t0 = [], time.perf_counter()
    for name, verts, faces, az in meshes:
        ndc, faces, attrs = normal_inputs(verts, faces, az)
        weights = phase9_weights(az, dev)
        res = compare(ndc, faces, attrs, weights)
        if args.meshes:
            res["raster_bwd_ms"] = bwd_ms(ndc, faces, attrs, weights)
        print(name, res, flush=True)
        kept = sorted(kept + [(res["rel"], name, verts, faces, az)],
                      key=lambda t: -t[0])[:KEEP]
    if args.save and not args.meshes:
        os.makedirs(args.save, exist_ok=True)
        for rel, name, verts, faces, az in kept:
            np.savez_compressed(osp.join(args.save, name + ".npz"),
                                verts=verts.cpu().numpy(),
                                faces=faces.cpu().numpy(), az=az)
            print(f"saved {name} (gap {rel:.3g} of the largest)")
    print(f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
