"""In-the-wild photo dataset: photo -> crop -> HPS -> SMPL init
(``icon_tpu.data.test_dataset``; reference lib/dataset/TestDataset.py:90-287
and lib/pymaf/utils/imutils.py:89-185).

Images with an alpha channel use it as the person matte, whose box drives
the crop. RGB images take ``models.detector.detect_and_matte``: the
YOLOv3-tiny person box when ``data/HPS/yolov3-tiny.weights`` is installed
(the reference's ``human_det``), else the saliency box; inside it the
U^2-Net matte when ``data/HPS/u2net.pth`` or ``u2netp.pth`` is installed
(the reference's rembg), else the saliency matte. Both nets run on the
dataset's device; an installed file that does not load raises. The HPS is
PyMAF or PARE; the others are ROADMAP Queue A item A8 (rest).

An item holds (TestDataset.py:232-287): ``image [S, S, 3]`` in [-1, 1]
masked, ``mask [S, S]``, ``betas [1, 10]``, ``body_pose [1, 23, 3, 3]``,
``global_orient [1, 1, 3, 3]``, ``smpl_verts``, ``scale``, ``trans [3]``,
all numpy.
"""

from __future__ import annotations

import glob
import os.path as osp
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_NOT_PORTED = "is not ported (ROADMAP Queue A item A8 (rest))"


def alpha_bbox(alpha: np.ndarray, thresh: float = 0.5,
               margin: float = 0.1) -> Tuple[int, int, int]:
    """Square crop box (top, left, size) around the matte (the reference's
    detector box with aug_matrix scaling, imutils.py:89-130)."""
    ys, xs = np.where(alpha > thresh)
    H, W = alpha.shape
    if len(ys) == 0:
        return 0, 0, min(H, W)
    y0, y1 = ys.min(), ys.max()
    x0, x1 = xs.min(), xs.max()
    size = int(max(y1 - y0, x1 - x0) * (1 + 2 * margin))
    size = min(size, max(H, W))
    cy = (y0 + y1) // 2
    cx = (x0 + x1) // 2
    top = int(np.clip(cy - size // 2, 0, max(H - size, 0)))
    left = int(np.clip(cx - size // 2, 0, max(W - size, 0)))
    return top, left, size


def process_image(path: str, icon_size: int = 512, hps_size: int = 224,
                  segmenter: Optional[Callable] = None,
                  detector: Optional[Callable] = None,
                  stages: Optional[Dict[str, float]] = None):
    """(img_icon ``[S, S, 3]`` in [-1, 1] times the mask, img_hps ``[224,
    224, 3]`` ImageNet-normalized, mask ``[S, S]``, crop_param), numpy;
    PIL's bilinear resize on uint8, as the JAX package. An RGB photo takes
    ``detector``'s box and ``segmenter``'s matte when given
    (``detect_and_matte``, which adds its ``detect`` and ``matte`` seconds
    to ``stages``)."""
    from PIL import Image

    from icon_tpu_torch.models.detector import detect_and_matte
    im = Image.open(path)
    has_alpha = im.mode in ("RGBA", "LA") or "transparency" in im.info
    rgba = np.asarray(im.convert("RGBA"), np.float32) / 255.0
    rgb, alpha = rgba[..., :3], rgba[..., 3]
    if not has_alpha:
        alpha = detect_and_matte(rgb, segmenter, detector, stages=stages)

    top, left, size = alpha_bbox(alpha)
    H, W = alpha.shape
    pad_h = max(size - H, 0)
    pad_w = max(size - W, 0)
    rgb_p = np.pad(rgb, ((0, pad_h), (0, pad_w), (0, 0)))
    a_p = np.pad(alpha, ((0, pad_h), (0, pad_w)))
    crop_rgb = rgb_p[top:top + size, left:left + size]
    crop_a = a_p[top:top + size, left:left + size]

    def resize(img, s):
        arr = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
        return np.asarray(arr.resize((s, s), Image.BILINEAR),
                          np.float32) / 255.0

    icon_rgb = resize(crop_rgb, icon_size)
    icon_a = resize(crop_a[..., None].repeat(3, -1), icon_size)[..., 0]
    img_icon = (icon_rgb * 2 - 1) * (icon_a > 0.5)[..., None]

    hps_rgb = resize(crop_rgb * crop_a[..., None], hps_size)
    img_hps = (hps_rgb - IMAGENET_MEAN) / IMAGENET_STD

    crop_param = {"top": top, "left": left, "size": size, "ori_hw": (H, W)}
    return (img_icon.astype(np.float32), img_hps.astype(np.float32),
            (icon_a > 0.5).astype(np.float32), crop_param)


class PyMAFWrapper:
    """Callable HPS: ``[B, 224, 224, 3]`` -> the last iteration's output
    dict, on ``device``. Without a checkpoint the weights are PyMAF's
    seeded random initialization (``random_init``)."""

    def __init__(self, ckpt: str = "", device="cuda"):
        from icon_tpu_torch.models.pymaf.convert import load_pymaf_checkpoint
        from icon_tpu_torch.models.pymaf.net import build_pymaf
        self.device = torch.device(device)
        self.net, self.body = build_pymaf()
        self.faces = self.body.faces
        self.random_init = not (ckpt and osp.exists(ckpt))
        if not self.random_init:
            load_pymaf_checkpoint(self.net, ckpt)
        else:
            print("[hps] no PyMAF checkpoint found — RANDOM weights "
                  "(install data/HPS/pymaf_data to get real fits)")
        self.net.to(self.device).eval()
        self.body.to(self.device)

    @torch.no_grad()
    def __call__(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.net(img.to(self.device))["smpl_out"][-1]


class PAREWrapper:
    """Callable HPS: ``[B, 224, 224, 3]`` -> PARE's output dict, on
    ``device``. Without a checkpoint the weights are PARE's seeded random
    initialization (``random_init``)."""

    def __init__(self, ckpt: str = "", device="cuda"):
        from icon_tpu_torch.models.pare.convert import load_pare_checkpoint
        from icon_tpu_torch.models.pare.net import build_pare
        self.device = torch.device(device)
        self.net, self.body = build_pare()
        self.faces = self.body.faces
        self.random_init = not (ckpt and osp.exists(ckpt))
        if not self.random_init:
            load_pare_checkpoint(self.net, ckpt)
        else:
            print("[hps] no PARE checkpoint found — RANDOM weights")
        self.net.to(self.device).eval()
        self.body.to(self.device)

    @torch.no_grad()
    def __call__(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.net(img.to(self.device))


def get_hps(hps_type: str = "pymaf", ckpt: str = "", device="cuda"):
    """The HPS registry (reference TestDataset.py:90-126): PyMAF and PARE."""
    from icon_tpu_torch.models.smplx.assets import data_root
    if hps_type == "pymaf":
        if not ckpt:
            ckpt = osp.join(data_root(), "HPS", "pymaf_data",
                            "pretrained_model", "PyMAF_model_checkpoint.pt")
        return PyMAFWrapper(ckpt, device)
    if hps_type == "pare":
        if not ckpt:
            ckpt = osp.join(data_root(), "HPS", "pare_data",
                            "pare_checkpoint.ckpt")
        return PAREWrapper(ckpt, device)
    raise NotImplementedError(f"hps_type {hps_type!r} {_NOT_PORTED}")


class TestDataset:
    """In-the-wild inference dataset (reference TestDataset); its HPS runs
    on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, image_dir: str, hps_type: str = "pymaf",
                 hps_ckpt: str = "", icon_size: int = 512,
                 allow_random_hps: bool = False, device="cuda"):
        exts = ("*.png", "*.jpg", "*.jpeg", "*.webp")
        self.subject_list = sorted(sum(
            [glob.glob(osp.join(image_dir, e)) for e in exts], []))
        self.hps_type = hps_type
        self.icon_size = icon_size
        self.allow_random_hps = allow_random_hps
        self.device = torch.device(device)
        self._hps = None
        self._hps_ckpt = hps_ckpt
        self._segmenter = None
        self._detector = None

    def __len__(self):
        return len(self.subject_list)

    @property
    def hps(self):
        if self._hps is None:
            hps = get_hps(self.hps_type, self._hps_ckpt, self.device)
            # a random-init HPS exports meaningless bodies; the reference
            # fails without its data, and so does this unless asked
            if hps.random_init and not self.allow_random_hps:
                raise RuntimeError(
                    f"{self.hps_type} has no checkpoint installed — every "
                    "fit would be random garbage. Install the weights under "
                    "data/HPS/ (see README) or pass allow_random_hps=True "
                    "(-allow_random_hps on the CLI) for smoke tests.")
            self._hps = hps
        return self._hps

    @property
    def segmenter(self):
        """U^2-Net matting on the dataset's device for RGB photos when its
        checkpoint is installed (``data/HPS/u2net.pth``, else
        ``u2netp.pth``: the reference's rembg), else None."""
        if self._segmenter is None:
            from icon_tpu_torch.models.smplx.assets import data_root
            for name, lite in (("u2net.pth", False), ("u2netp.pth", True)):
                p = osp.join(data_root(), "HPS", name)
                if osp.exists(p):
                    from icon_tpu_torch.models.u2net import build_segmenter
                    self._segmenter = build_segmenter(p, lite, self.device)
                    break
            else:
                self._segmenter = False
        return self._segmenter or None

    @property
    def detector(self):
        """The YOLOv3-tiny person detector on the dataset's device when its
        darknet weights are installed (``data/HPS/yolov3-tiny.weights``: the
        reference's human_det), else None (RGB photos take the saliency
        box)."""
        if self._detector is None:
            from icon_tpu_torch.models.smplx.assets import data_root
            p = osp.join(data_root(), "HPS", "yolov3-tiny.weights")
            if osp.exists(p):
                from icon_tpu_torch.models.yolo import PersonDetector
                self._detector = PersonDetector(p, device=self.device)
            else:
                self._detector = False
        return self._detector or None

    def preprocess(self, index: int,
                   stages: Optional[Dict[str, float]] = None):
        """(name, the :func:`process_image` tuple) of photo ``index``: the
        host half of an item, with the detector and the matting net when
        installed (their seconds added to ``stages``)."""
        path = self.subject_list[index]
        name = osp.splitext(osp.basename(path))[0]
        return name, process_image(
            path, icon_size=self.icon_size, segmenter=self.segmenter,
            detector=self.detector, stages=stages)

    @torch.no_grad()
    def estimate(self, name: str, processed) -> Dict[str, Any]:
        """The item of a :meth:`preprocess` result: the HPS on the device
        and its branch of the adaptation (TestDataset.py:232-287)."""
        img_icon, img_hps, mask, crop_param = processed
        out = self.hps(torch.from_numpy(img_hps)[None])
        if self.hps_type == "pare":
            rotmat, verts, cam = (out["pred_pose"], out["smpl_vertices"],
                                  out["pred_cam"])
        else:                                        # pymaf
            rotmat, verts, cam = out["rotmat"], out["verts"], out["pred_cam"]
        scale, tran_x, tran_y = (float(v) for v in cam[0, :3].cpu().numpy())
        rotmat = rotmat.cpu().numpy()
        return {
            "name": name, "image": img_icon, "mask": mask,
            "crop_param": crop_param, "smpl_faces": self.hps.faces,
            "betas": out["pred_shape"].cpu().numpy(),
            "body_pose": rotmat[:, 1:], "global_orient": rotmat[:, 0:1],
            "smpl_verts": verts.cpu().numpy(), "scale": scale,
            "trans": np.array([tran_x, tran_y, 0.0], np.float32)}

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.estimate(*self.preprocess(index))
