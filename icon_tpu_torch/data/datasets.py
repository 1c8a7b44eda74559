"""The geometry trainer's dataset in the reference's on-disk layout
(``icon_tpu.data.datasets``; reference lib/dataset/PIFuDataset.py)::

    {root}/{dataset}_{R}views/{subject}/{render,normal_F,normal_B,
        T_normal_F,T_normal_B,calib,vis}/{rotation:03d}.*
    {root}/{dataset}/scans/{subject}/{subject}.obj
    {root}/{dataset}/fits/{subject}/smplx_param.pkl
    {root}/{dataset}/{split}.txt

An item is host numpy, the same arrays as the JAX package's item for the
same files and epoch: images premultiplied by their mask in [-1, 1]
(``(rgb * 2 - 1) * alpha``), the sample points and their occupancy labels
signed by the scan's winding number (``ops/winding_np.py``), and for the
body prior the fitted SMPL-X body with pose and shape noise, projected to
calib space, its visibility, colour map and vertex-face table, and the
samples' signs against it by ray parity
(``ops/sdf_fast.py:ray_parity_inside_np``). Items are seeded by
:func:`stable_hash` of the subject and rotation and by the epoch, so an item
does not depend on which worker makes it.

:class:`NormalDataset` gives the NormalNet trainer the five images of the
same items, read alone.

:func:`make_loader` batches them in the JAX loader's order, the items made
by a ``torch.utils.data.DataLoader``'s ``num_workers`` worker processes
(the JAX package decodes in threads), collating the keys of
:data:`SHARED_KEYS` once per batch. Its workers end when an iterator is
exhausted or closed (:func:`close_iter`); it keeps no persistent workers.

The host helpers (:func:`projection_np`, :func:`stable_hash`,
:func:`vertex_normals_np`, :class:`HoppeSDF`,
:func:`sample_points_with_labels`) are copies of the JAX module's, pinned by
``tests/test_torch_copies.py``.
"""

from __future__ import annotations

import os
import os.path as osp
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from icon_tpu_torch.config import Config

# Keys shared across a batch (same body topology / assets for every sample):
# collated by taking the first item instead of stacking.
SHARED_KEYS = ("smpl_faces", "smpl_vf_table", "voxel_codes", "voxel_faces")
# the image maps an item may hold (the filter's and the NormalNet's inputs)
MAP_KEYS = ("image", "normal_F", "normal_B", "T_normal_F", "T_normal_B")

# reference noise joints (PIFuDataset.py:58-71); smplx indices are
# (idx-1)*3.. because body_pose excludes the global root
_NOISE_JOINTS = [4, 5, 7, 8, 13, 14, 16, 17, 18, 19, 20, 21]
NOISE_SMPLX_IDX = [(i - 1) * 3 + k for i in _NOISE_JOINTS for k in range(3)]
NOISE_SMPL_IDX = [i * 3 + k for i in _NOISE_JOINTS for k in range(3)]


def imagepath2tensor(path: str, channels: int = 3) -> np.ndarray:
    """An RGBA PNG as ``[H, W, channels]`` float32: RGB scaled to [-1, 1],
    then multiplied by the alpha, so the background is exactly 0 (reference
    imagepath2tensor, PIFuDataset.py:250-259)."""
    from PIL import Image
    rgba = Image.open(path).convert("RGBA")
    arr = np.asarray(rgba, np.float32) / 255.0
    rgb, mask = arr[..., :3], arr[..., 3:4]
    out = (rgb * 2.0 - 1.0) * mask
    return out[..., :channels].astype(np.float32)


def load_calib(path: str) -> np.ndarray:
    """calib txt: 4x4 extrinsic over 4x4 intrinsic stacked (8 rows)."""
    data = np.loadtxt(path, dtype=np.float32)
    return (data[4:8] @ data[:4]).astype(np.float32)


def projection_np(points: np.ndarray, calib: np.ndarray) -> np.ndarray:
    """Homogeneous [N, 3] @ [4, 4] projection (lib/net/geometry.py math)."""
    h = np.concatenate(
        [points, np.ones((len(points), 1), points.dtype)], axis=1)
    return (h @ calib.T)[:, :3]


def stable_hash(text: str, mod: int = 10 ** 8) -> int:
    """Deterministic stand-in for the reference's ``hash(...) % 1e8`` noise
    seeds (PIFuDataset.py:300) — python's hash() is salted per process."""
    return zlib.crc32(text.encode()) % mod


def vertex_normals_np(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals on the host."""
    tri = verts[faces]                                  # [F, 3, 3]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(verts)
    for j in range(3):
        np.add.at(vn, faces[:, j], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


class HoppeSDF:
    """Signed distance via nearest-vertex + normal dot — the reference's
    HoppeMesh (lib/dataset/hoppeMesh.py:73-116), cKDTree on host.
    Negative inside (matching the reference's get_sdf sign convention)."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray,
                 vert_normals: Optional[np.ndarray] = None):
        from scipy.spatial import cKDTree
        self.verts = np.asarray(verts, np.float32)
        self.faces = np.asarray(faces)
        self.vert_normals = vertex_normals_np(self.verts, self.faces) \
            if vert_normals is None else np.asarray(vert_normals, np.float32)
        self.tree = cKDTree(self.verts)

    def query(self, points: np.ndarray) -> np.ndarray:
        dist, idx = self.tree.query(points, k=4)
        # Hoppe: signed distance to the plane of the nearest point
        gap = points[:, None, :] - self.verts[idx]      # [N, 4, 3]
        signed = np.einsum("nkc,nkc->nk", gap, self.vert_normals[idx])
        w = 1.0 / np.maximum(dist, 1e-8)
        return (np.sum(signed * w, axis=1) / np.sum(w, axis=1)).astype(
            np.float32)

    def contains(self, points: np.ndarray) -> np.ndarray:
        return self.query(points) < 0.0


class PIFuDataset(torch.utils.data.Dataset):
    """Map-style geometry-training dataset (reference PIFuDataset)."""

    def __init__(self, cfg: Config, split: str = "train"):
        self.cfg = cfg
        self.split = split
        self.opt = cfg.dataset
        self.root = self.opt.root
        self.rotations = list(range(0, 360,
                                    360 // max(self.opt.rotation_num, 1)))
        self.scales = dict(zip(self.opt.types, self.opt.scales))
        self.prior_type = cfg.net.prior_type
        self.epoch = 0
        self.noise_type = tuple(self.opt.noise_type)
        self.noise_scale = tuple(self.opt.noise_scale)

        self.subjects: List[str] = []
        for d in self.opt.types:
            split_file = osp.join(self.root, d, f"{split}.txt")
            if osp.exists(split_file):
                with open(split_file) as f:
                    self.subjects += [f"{d}/{line.strip()}"
                                      for line in f if line.strip()]
            else:
                views_dir = osp.join(self.root,
                                     f"{d}_{self.opt.rotation_num}views")
                if osp.isdir(views_dir):
                    self.subjects += [f"{d}/{s}"
                                      for s in sorted(os.listdir(views_dir))]
        self._cache: Dict[str, object] = {}

    def set_epoch(self, epoch: int) -> None:
        """Advance the sampling seed so each epoch draws fresh points."""
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.subjects) * len(self.rotations)

    def _paths(self, subject: str, rotation: int) -> Dict[str, str]:
        d, s = subject.split("/")
        folder = osp.join(self.root, f"{d}_{self.opt.rotation_num}views", s)
        return {
            "calib": osp.join(folder, "calib", f"{rotation:03d}.txt"),
            "render": osp.join(folder, "render", f"{rotation:03d}.png"),
            "vis": osp.join(folder, "vis", f"{rotation:03d}"),
            "folder": folder,
            "mesh": osp.join(self.root, d, "scans", s, f"{s}.obj"),
            "fit": osp.join(self.root, d, "fits", s, "smplx_param.pkl"),
        }

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.cfg.overfit:
            index = 0
        rotation = self.rotations[index % len(self.rotations)]
        subject = self.subjects[index // len(self.rotations)]
        p = self._paths(subject, rotation)

        item = {"subject": subject, "rotation": rotation,
                "calib": load_calib(p["calib"]),
                "image": imagepath2tensor(p["render"])}
        for name in MAP_KEYS[1:]:
            path = osp.join(p["folder"], name, f"{rotation:03d}.png")
            if osp.exists(path):
                item[name] = imagepath2tensor(path)

        verts, faces, hoppe, winding = self._mesh(p["mesh"], subject)
        seed = (stable_hash(f"{subject}_{rotation}")
                ^ (self.epoch * 0x9E3779B9)) % (2 ** 31)
        samples, labels = sample_points_with_labels(
            verts, faces, item["calib"],
            num_sample_geo=self.opt.num_sample_geo,
            sigma_geo=self.opt.sigma_geo / 100.0, seed=seed,
            use_sdf=self.cfg.sdf, sdf_clip=self.cfg.sdf_clip / 100.0,
            hoppe=hoppe, winding=winding)
        item["sample"] = samples
        item["label"] = labels[:, None]

        if osp.exists(p["fit"]):
            item.update(self.load_smpl(p, subject, rotation, item["calib"],
                                       samples))
            if self.prior_type == "pamir":
                item.update(self.load_smpl_voxel(p, subject, rotation,
                                                 item["calib"]))
        if self.split in ("test", "val"):
            item["verts"] = verts
            item["faces"] = faces
        return item

    def _mesh(self, path: str, subject: str):
        """The scan, its Hoppe SDF and its winding clusters, once per
        subject."""
        key = f"mesh_{subject}"
        if key not in self._cache:
            from icon_tpu_torch.ops.winding_np import FastWinding
            from icon_tpu_torch.utils.io import load_obj
            verts, faces = load_obj(path)
            verts = verts * self.scales.get(subject.split("/")[0], 1.0)
            self._cache[key] = (verts, faces, HoppeSDF(verts, faces),
                                FastWinding(verts, faces))
        return self._cache[key]

    def _noise(self, name: str) -> float:
        nt = list(self.noise_type)
        return self.noise_scale[nt.index(name)] if name in nt else 0.0

    def compute_smpl_verts(self, fit_path: str, subject: str, rotation: int,
                           scale: float):
        """Fitted SMPL-X verts with pose/beta noise
        (PIFuDataset.compute_smpl_verts :322-350, add_noise :291-320)."""
        from icon_tpu_torch.models.smplx.assets import (load_fit_body,
                                                        load_smplx_param)
        param = load_smplx_param(fit_path)
        pose = np.array(param["body_pose"], np.float32).reshape(-1).copy()
        betas = np.array(param["betas"], np.float32).reshape(-1).copy()

        rng = np.random.RandomState(
            stable_hash(f"{subject.split('/')[-1]}_{rotation}"))
        if self._noise("beta") > 0:
            betas = betas + (rng.rand(len(betas)) - 0.5) * 2.0 * \
                self._noise("beta")
        if self._noise("pose") > 0:
            idx = [i for i in NOISE_SMPLX_IDX if i < len(pose)]
            pose[idx] += ((rng.rand(len(idx)) - 0.5) * 2.0 * np.pi *
                          self._noise("pose")).astype(np.float32)
        noise_dict = dict(betas=betas[None].astype(np.float32),
                          body_pose=pose[None].astype(np.float32))
        verts, _, faces = load_fit_body(fit_path, scale,
                                        noise_dict=noise_dict)
        return verts, faces

    def load_smpl(self, p: Dict[str, str], subject: str, rotation: int,
                  calib: np.ndarray, samples: np.ndarray
                  ) -> Dict[str, np.ndarray]:
        """The body prior's inputs in calib space (load_smpl,
        PIFuDataset.py:402-465)."""
        from icon_tpu_torch.models.smplx.assets import (SMPLX,
                                                        cached_smpl_model)
        from icon_tpu_torch.ops.sdf_fast import (build_vertex_face_table,
                                                 ray_parity_inside_np)
        scale = self.scales.get(subject.split("/")[0], 1.0)
        smpl_verts, smpl_faces = self.compute_smpl_verts(
            p["fit"], subject, rotation, scale)
        smpl_verts = projection_np(smpl_verts, calib).astype(np.float32)

        # per-view visibility: the offline renderer's .npy, or the
        # reference's .pt
        vis = None
        for ext, loader in ((".npy", np.load), (".pt", _torch_load_np)):
            if osp.exists(p["vis"] + ext):
                vis = np.asarray(loader(p["vis"] + ext),
                                 np.float32).reshape(-1, 1)
                break
        if vis is None:
            # front-facing heuristic (outward normal toward the camera)
            vn = vertex_normals_np(smpl_verts, smpl_faces)
            vis = (vn[:, 2:3] < 0.0).astype(np.float32)

        reg = SMPLX()
        if osp.exists(reg.cmap_vert_path):
            cmap = reg.cmap.astype(np.float32)
        else:
            t = cached_smpl_model().v_template.numpy()
            cmap = ((t - t.min(0)) / (t.max(0) - t.min(0))).astype(np.float32)

        # the samples' signs against the body: ray-stabbing parity, the
        # reference's kaolin check_sign (PIFuDataset.py:418)
        query = projection_np(samples, calib).astype(np.float32)
        inside = ray_parity_inside_np(query, smpl_verts, smpl_faces)
        key = f"vf_{len(smpl_verts)}_{len(smpl_faces)}"
        if key not in self._cache:
            self._cache[key] = build_vertex_face_table(smpl_faces,
                                                       len(smpl_verts))
        return {"smpl_verts": smpl_verts,
                "smpl_faces": smpl_faces.astype(np.int32),
                "smpl_vis": vis,
                "smpl_cmap": cmap[:len(smpl_verts)],
                "pts_signs": np.where(inside, 1.0, -1.0).astype(np.float32),
                "smpl_vf_table": self._cache[key],
                "smpl_query_inside": inside}

    def load_smpl_voxel(self, p: Dict[str, str], subject: str, rotation: int,
                        calib: np.ndarray) -> Dict[str, np.ndarray]:
        """PaMIR's voxel vertices and semantic codes (load_smpl_voxel,
        PIFuDataset.py:352-400,466-481): the tetrahedral SMPL when its
        assets are installed, else the fitted SMPL-X surface; padded to
        8,000 vertices, projected, then halved."""
        from icon_tpu_torch.models.smplx.assets import SMPLX
        reg = SMPLX()
        scale = self.scales.get(subject.split("/")[0], 1.0)
        tetra_model = osp.join(reg.model_dir, "smpl", "SMPL_MALE.pkl")
        tetra_add = osp.join(reg.tedra_dir, "tetra_male_adult_smpl.npz")
        if osp.exists(tetra_model) and osp.exists(tetra_add):
            verts, codes = self._tetra_verts(p, scale, tetra_model,
                                             tetra_add)
        else:
            verts, _ = self.compute_smpl_verts(p["fit"], subject, rotation,
                                               scale)
            codes = ((verts - verts.min(0)) /
                     np.maximum(verts.max(0) - verts.min(0), 1e-6))
        pad_v = max(8000 - len(verts), 0)
        verts = np.pad(verts[:8000], ((0, pad_v), (0, 0)))
        codes = np.pad(codes[:8000], ((0, pad_v), (0, 0)))
        verts = projection_np(verts, calib) * 0.5
        return {"voxel_verts": verts.astype(np.float32),
                "voxel_codes": codes.astype(np.float32)}

    def _tetra_verts(self, p, scale, model_path, add_path):
        from icon_tpu_torch.models.smplx.assets import load_smplx_param
        from icon_tpu_torch.models.smplx.tetra import load_tetra_body_model
        model, _ = load_tetra_body_model(model_path, add_path)
        param = load_smplx_param(p["fit"])
        # the SMPL-X fit's first 23*3 pose dofs drive the tetra SMPL
        pose = np.array(param["body_pose"], np.float32).reshape(-1)[:69]
        pose = np.pad(pose, (0, 69 - len(pose)))
        betas = np.array(param["betas"], np.float32).reshape(-1)[:10]
        orient = np.array(param["global_orient"], np.float32).reshape(1, 3)
        with torch.no_grad():
            verts, _ = model(betas=torch.from_numpy(betas[None]),
                             global_orient=torch.from_numpy(orient),
                             body_pose=torch.from_numpy(pose[None]))
        verts = verts[0].numpy()
        fit_scale = float(np.asarray(param.get("scale", 1.0)).reshape(()))
        transl = np.asarray(param.get("translation", np.zeros(3)),
                            np.float32).reshape(3)
        verts = (verts * fit_scale + transl) * scale
        t = model.v_template.numpy()
        codes = ((t - t.min(0)) / np.maximum(t.max(0) - t.min(0), 1e-6))
        return verts.astype(np.float32), codes.astype(np.float32)


class NormalDataset(torch.utils.data.Dataset):
    """The NormalNet's pairs (``icon_tpu.data.datasets.NormalDataset``;
    reference NormalDataset.py): an item holds ``image``, ``T_normal_F``,
    ``T_normal_B``, ``normal_F`` and ``normal_B`` (those whose files
    exist), the same arrays as :class:`PIFuDataset`'s item for the same
    index. Only the five images are read: the scan, the body and the
    geometry samples of a full item are not made."""

    def __init__(self, cfg: Config, split: str = "train"):
        self.inner = PIFuDataset(cfg, split)

    def __len__(self):
        return len(self.inner)

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        inner = self.inner
        if inner.cfg.overfit:
            index = 0
        rotation = inner.rotations[index % len(inner.rotations)]
        subject = inner.subjects[index // len(inner.rotations)]
        p = inner._paths(subject, rotation)
        item = {"image": imagepath2tensor(p["render"])}
        for name in MAP_KEYS[1:]:
            path = osp.join(p["folder"], name, f"{rotation:03d}.png")
            if osp.exists(path):
                item[name] = imagepath2tensor(path)
        return item


def _torch_load_np(path: str) -> np.ndarray:
    return torch.load(path, map_location="cpu", weights_only=True).numpy()


def sample_points_with_labels(verts: np.ndarray, faces: np.ndarray,
                              calib: np.ndarray, num_sample_geo: int,
                              sigma_geo: float, seed: int = 0,
                              use_sdf: bool = False,
                              sdf_clip: float = 0.05,
                              hoppe: Optional[HoppeSDF] = None,
                              winding=None):
    """get_sampling_geo on host (PIFuDataset.py:483-607).

    Surface samples are area-weighted over faces with barycentric jitter,
    offset along interpolated normals by N(0, sigma_geo), plus
    num_sample_geo/4 uniform samples in the view cube. The inside/outside
    label comes from the generalized winding number (ops/winding_np.py),
    the Hoppe query supplies the SDF magnitude for ``use_sdf``; the labels
    are rebalanced to num_sample_geo."""
    rng = np.random.RandomState(seed)

    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(fn, axis=1)
    fprob = area / max(area.sum(), 1e-12)

    n_surf = 4 * num_sample_geo
    fids = rng.choice(len(faces), n_surf, p=fprob)
    r1 = np.sqrt(rng.rand(n_surf, 1)).astype(np.float32)
    r2 = rng.rand(n_surf, 1).astype(np.float32)
    w0, w1, w2 = 1 - r1, r1 * (1 - r2), r1 * r2
    t = tri[fids]
    samples_surface = (w0 * t[:, 0] + w1 * t[:, 1] + w2 * t[:, 2]).astype(
        np.float32)
    vn = hoppe.vert_normals if hoppe is not None \
        else vertex_normals_np(verts, faces)
    n_interp = (w0 * vn[faces[fids, 0]] + w1 * vn[faces[fids, 1]] +
                w2 * vn[faces[fids, 2]])
    n_interp /= np.maximum(np.linalg.norm(n_interp, axis=1, keepdims=True),
                           1e-12)
    offset = rng.normal(scale=sigma_geo, size=(n_surf, 1)).astype(np.float32)
    samples_surface = samples_surface + n_interp * offset

    n_space = num_sample_geo // 4
    calib_inv = np.linalg.inv(calib)
    space_img = (2.0 * rng.rand(n_space, 3) - 1.0).astype(np.float32)
    samples_space = projection_np(space_img, calib_inv)

    samples = np.concatenate([samples_surface, samples_space]).astype(
        np.float32)
    rng.shuffle(samples)

    if hoppe is None:
        hoppe = HoppeSDF(verts, faces)
    if winding is None:
        from icon_tpu_torch.ops.winding_np import FastWinding
        winding = FastWinding(verts, faces)
    inside_exact = winding.contains(samples)
    mag = np.abs(hoppe.query(samples))
    sdf = np.where(inside_exact, -mag, mag)

    if use_sdf:
        order = np.argsort(sdf >= 0, kind="stable")      # inside first
        keep = np.concatenate([
            order[sdf[order] < 0][:num_sample_geo // 2],
            order[sdf[order] >= 0][:num_sample_geo // 2]])
        samples, sdfv = samples[keep], sdf[keep]
        # clip + map to occupancy-like [0,1], inside -> 1 (reference
        # get_sampling_geo sdf branch)
        labels = (-np.clip(sdfv, -sdf_clip, sdf_clip) + sdf_clip) \
            / (2 * sdf_clip)
    else:
        inside = sdf < 0
        inside_samples = samples[inside]
        outside_samples = samples[~inside]
        nin = len(inside_samples)
        half = num_sample_geo // 2
        if nin > half:
            inside_samples = inside_samples[:half]
            outside_samples = outside_samples[:half]
        else:
            outside_samples = outside_samples[:num_sample_geo - nin]
        samples = np.concatenate([inside_samples, outside_samples])
        labels = np.concatenate([np.ones(len(inside_samples), np.float32),
                                 np.zeros(len(outside_samples), np.float32)])
    # pad to fixed size (static shapes downstream)
    short = num_sample_geo - len(samples)
    if short > 0:
        samples = np.concatenate([samples, samples[:1].repeat(short, 0)])
        labels = np.concatenate([labels, labels[:1].repeat(short)])
    return samples.astype(np.float32), labels.astype(np.float32)


def collate(items: List[Dict]) -> Dict:
    """One batch: the keys of :data:`SHARED_KEYS` from the first item,
    arrays stacked into CPU tensors, anything else as a list."""
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if k in SHARED_KEYS:
            out[k] = torch.from_numpy(np.asarray(vals[0]))
        elif isinstance(vals[0], np.ndarray):
            out[k] = torch.from_numpy(np.stack(vals))
        else:
            out[k] = vals
    return out


class EpochSampler:
    """The JAX loader's batches: indices shuffled by
    ``RandomState(seed + epoch)``, cut into whole batches (``drop_last``),
    or with ``pad_last`` the ragged last batch wrapped around to full
    size. With ``process_count`` > 1 each process takes its contiguous
    ``batch_size / process_count`` slice of every global batch
    (``process_index``-th), so the ranks' items tile the global batch. A
    ragged final batch cannot split evenly and raises (the JAX loader keeps
    it global on every process, which steps every rank on the same items:
    ROADMAP Queue C, "Ragged final batch")."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, seed: int,
                 drop_last: bool, pad_last: bool, process_index: int = 0,
                 process_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside "
                             f"[0, {process_count})")
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_count} processes")
        self.n, self.batch_size = n, batch_size
        self.shuffle, self.seed = shuffle, seed
        self.drop_last, self.pad_last = drop_last, pad_last
        self.process_index, self.process_count = process_index, process_count
        self.epoch = 0

    def batches(self) -> List[List[int]]:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, self.n, self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        elif self.pad_last and batches and \
                len(batches[-1]) < self.batch_size:
            short = len(batches[-1])
            fill = order[np.arange(self.batch_size - short) % self.n]
            batches[-1] = np.concatenate([batches[-1], fill])
        if self.process_count > 1:
            if batches and len(batches[-1]) != self.batch_size:
                raise ValueError(
                    f"the final batch holds {len(batches[-1])} of "
                    f"{self.batch_size} items and cannot split over "
                    f"{self.process_count} processes: pass drop_last or "
                    "pad_last")
            lb = self.batch_size // self.process_count
            lo = self.process_index * lb
            batches = [b[lo:lo + lb] for b in batches]
        return [[int(i) for i in b] for b in batches]


def _item(x):
    return x


def _worker_init(_):
    torch.set_num_threads(1)


class Loader:
    """Batches of :func:`collate` in the JAX loader's order. Each iterator
    runs a ``torch.utils.data.DataLoader`` over the epoch's items, one item
    a fetch, so ``num_workers`` worker processes (forked when the iterator
    starts, so they copy the current epoch) make a batch's items side by
    side; the batch is collated here. The workers end when the iterator is
    exhausted or closed (:func:`close_iter`)."""

    def __init__(self, dataset: PIFuDataset, sampler: EpochSampler,
                 num_workers: int):
        self.dataset, self.sampler = dataset, sampler
        self.num_workers = num_workers

    def __len__(self) -> int:
        return len(self.sampler.batches())

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle and the dataset's sampling."""
        self.sampler.epoch = int(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self) -> "_Batches":
        return _Batches(self)


class _Batches:
    def __init__(self, loader: Loader):
        batches = loader.sampler.batches()
        self._sizes = [len(b) for b in batches]
        workers = loader.num_workers
        self._items = iter(torch.utils.data.DataLoader(
            loader.dataset, batch_size=None,
            sampler=[i for b in batches for i in b], num_workers=workers,
            collate_fn=_item, persistent_workers=False,
            worker_init_fn=_worker_init if workers else None,
            multiprocessing_context="fork" if workers else None))

    def __iter__(self) -> "_Batches":
        return self

    def __next__(self) -> Dict:
        if not self._sizes:
            self.close()
            raise StopIteration
        return collate([next(self._items) for _ in range(self._sizes.pop(0))])

    def close(self) -> None:
        """End the worker processes now."""
        shutdown = getattr(self._items, "_shutdown_workers", None)
        if shutdown is not None:
            shutdown()


def make_loader(dataset: torch.utils.data.Dataset, batch_size: int = 4,
                shuffle: bool = True, num_workers: int = 4, seed: int = 0,
                drop_last: bool = True, pad_last: bool = False,
                process_index: int = 0, process_count: int = 1) -> Loader:
    """The JAX ``DataLoader``'s batches, made by ``num_workers`` worker
    processes (0: in this process); with ``process_count`` > 1 this
    process's slice of each (see :class:`EpochSampler`)."""
    return Loader(dataset, EpochSampler(len(dataset), batch_size, shuffle,
                                        seed, drop_last, pad_last,
                                        process_index, process_count),
                  num_workers)


def close_iter(it: "_Batches") -> None:
    """End a loader iterator's worker processes now (a ``break`` out of a
    loop otherwise leaves them to the garbage collector)."""
    it.close()
