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
one of the demo's five (``get_hps``): PyMAF, PARE, PIXIE (an SMPL-X body),
HybrIK, or BEV around the external ``simple-romp`` package.

An item holds (TestDataset.py:232-287): ``image [S, S, 3]`` in [-1, 1]
masked, ``mask [S, S]``, ``betas [1, 10]``, ``body_pose [1, 23, 3, 3]``,
``global_orient [1, 1, 3, 3]``, ``smpl_verts``, ``scale``, ``trans [3]``,
all numpy; PIXIE's has ``betas [1, 200]`` (its whole shape space), a
21-joint ``body_pose`` and also ``exp``, ``jaw_pose``, ``left_hand_pose``
and ``right_hand_pose``.
"""

from __future__ import annotations

import glob
import os.path as osp
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


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
                  stages: Optional[Dict[str, float]] = None,
                  return_raw: bool = False):
    """(img_icon ``[S, S, 3]`` in [-1, 1] times the mask, img_hps ``[224,
    224, 3]`` ImageNet-normalized, mask ``[S, S]``, crop_param), numpy;
    PIL's bilinear resize on uint8, as the JAX package. An RGB photo takes
    ``detector``'s box and ``segmenter``'s matte when given
    (``detect_and_matte``, which adds its ``detect`` and ``matte`` seconds
    to ``stages``). With ``return_raw`` a fifth entry, the unmasked crop
    as uint8 ``[S, S, 3]``, for an HPS that runs its own detection (BEV;
    the reference hands it the raw crop, imutils.py process_image)."""
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
    out = (img_icon.astype(np.float32), img_hps.astype(np.float32),
           (icon_a > 0.5).astype(np.float32), crop_param)
    if return_raw:
        return out + ((resize(crop_rgb, icon_size) * 255).astype(np.uint8),)
    return out


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


class PIXIEWrapper:
    """Callable HPS: ``[B, 224, 224, 3]`` -> PIXIE's SMPL-X output dict, on
    ``device``. Without a checkpoint the weights are PIXIE's seeded random
    initialization (``random_init``)."""

    def __init__(self, ckpt: str = "", device="cuda"):
        from icon_tpu_torch.models.pixie.convert import load_pixie_checkpoint
        from icon_tpu_torch.models.pixie.net import build_pixie
        self.device = torch.device(device)
        self.est, self.body = build_pixie()
        self.faces = self.body.faces
        self.random_init = not (ckpt and osp.exists(ckpt))
        if not self.random_init:
            load_pixie_checkpoint(self.est.net, ckpt)
        else:
            print("[hps] no PIXIE checkpoint found — RANDOM weights")
        self.est.to(self.device)

    @torch.no_grad()
    def __call__(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.est(img.to(self.device))


class HybrIKWrapper:
    """Callable HPS: ``[B, H, W, 3]`` -> HybrIK's output dict, on
    ``device``; the image is resized to HybrIK's 256^2 as
    ``jax.image.resize(..., "bilinear")`` upsamples it (half-pixel
    centres). Without a checkpoint the weights are HybrIK's seeded random
    initialization (``random_init``)."""

    def __init__(self, ckpt: str = "", device="cuda"):
        from icon_tpu_torch.models.hybrik.convert import \
            load_hybrik_checkpoint
        from icon_tpu_torch.models.hybrik.net import build_hybrik
        self.device = torch.device(device)
        self.net, self.body = build_hybrik()
        self.faces = self.body.faces
        self.random_init = not (ckpt and osp.exists(ckpt))
        if not self.random_init:
            load_hybrik_checkpoint(self.net, ckpt)
        else:
            print("[hps] no HybrIK checkpoint found — RANDOM weights")
        self.net.to(self.device).eval()
        self.body.to(self.device)

    @torch.no_grad()
    def __call__(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = img.to(self.device).permute(0, 3, 1, 2)
        if tuple(x.shape[2:]) != (256, 256):
            x = F.interpolate(x, size=(256, 256), mode="bilinear",
                              align_corners=False)
        return self.net(x)


def _rodrigues_np(aa: np.ndarray) -> np.ndarray:
    """``[N, 3]`` axis-angle -> ``[N, 3, 3]`` rotation matrices on the host
    (BEV's thetas arrive as numpy from the external package)."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True).clip(1e-8)
    k = aa / theta
    K = np.zeros((len(aa), 3, 3), np.float32)
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    s = np.sin(theta)[..., None]
    c = np.cos(theta)[..., None]
    return (np.eye(3, dtype=np.float32)[None] + s * K
            + (1 - c) * (K @ K)).astype(np.float32)


def adapt_bev_output(preds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """simple-romp BEV's numpy outputs -> the common HPS layout (reference
    TestDataset.py:263-276): ``betas[:10]``, the 72 axis-angle thetas as
    ``[1, 24, 3, 3]`` rotations, person 0's vertices, and the reference's
    empirical camera (scale ``cam[0] * 1.1``, tranX from the metric
    ``cam_trans``, tranY ``cam[1] + 0.28``)."""
    thetas = np.asarray(preds["smpl_thetas"])[0].reshape(-1, 3)
    rotmat = _rodrigues_np(thetas.astype(np.float32))[None]
    cam = np.asarray(preds["cam"], np.float32)
    cam_trans = np.asarray(preds["cam_trans"], np.float32)
    return {
        "rotmat": rotmat,
        "pred_shape": np.asarray(preds["smpl_betas"],
                                 np.float32)[0:1, :10],
        "verts": np.asarray(preds["verts"], np.float32)[0:1],
        "cam": np.array([[cam[0, 0] * 1.1, cam_trans[0, 0],
                          cam[0, 1] + 0.28]], np.float32),
    }


class BEVWrapper:
    """Callable HPS around the external ``simple-romp`` package's BEV
    (reference TestDataset.py:111-125; only the output adaptation is
    first-party, there as here). It takes the raw uint8 crop
    (``wants_raw``) and runs its own person detection. Its ``body`` is the
    SMPL model when it is installed, else the 24-joint synthetic stand-in,
    and ``faces`` are that body's."""

    wants_raw = True
    random_init = False             # the package ships trained weights

    def __init__(self, ckpt: str = "", device="cuda"):
        try:
            import bev
        except ImportError as e:
            raise RuntimeError(
                "hps_type 'bev' wraps the external `simple-romp` package "
                "(the reference installs it via pip, TestDataset.py:113-117)"
                " — `pip install simple-romp==1.0.3` to use it") from e
        settings = bev.main.default_settings
        settings.mode = "image"
        settings.show_largest = True    # single-subject pipeline
        self._bev = bev.BEV(settings)
        from icon_tpu_torch.models.pymaf.net import smpl_body
        self.body = smpl_body()
        self.faces = self.body.faces

    def __call__(self, raw_rgb: np.ndarray) -> Dict[str, np.ndarray]:
        # BEV takes BGR uint8 (cv2 conventions)
        preds = self._bev(np.ascontiguousarray(raw_rgb[..., ::-1]))
        if preds is None:
            raise RuntimeError("BEV found no person in the image")
        return adapt_bev_output(preds)


# the published checkpoints under data/HPS (reference TestDataset.py:90-126)
HPS_CKPTS = {
    "pymaf": ("pymaf_data", "pretrained_model", "PyMAF_model_checkpoint.pt"),
    "pare": ("pare_data", "pare_checkpoint.ckpt"),
    "pixie": ("pixie_data", "pixie_model.tar"),
    "hybrik": ("hybrik_data", "pretrained_w_cam.pth"),
}


def get_hps(hps_type: str = "pymaf", ckpt: str = "", device="cuda"):
    """The HPS registry (reference TestDataset.py:90-126): ``ckpt``, or the
    published file under ``data/HPS``, on ``device``."""
    from icon_tpu_torch.models.smplx.assets import data_root
    wrappers = {"pymaf": PyMAFWrapper, "pare": PAREWrapper,
                "pixie": PIXIEWrapper, "hybrik": HybrIKWrapper,
                "bev": BEVWrapper}
    if hps_type not in wrappers:
        raise NotImplementedError(
            f"hps_type {hps_type!r} unknown (available: pymaf, pare, "
            "hybrik, pixie, bev)")
    if not ckpt and hps_type in HPS_CKPTS:
        ckpt = osp.join(data_root(), "HPS", *HPS_CKPTS[hps_type])
    return wrappers[hps_type](ckpt, device)


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
            detector=self.detector, stages=stages,
            return_raw=self.hps_type == "bev")

    @torch.no_grad()
    def estimate(self, name: str, processed) -> Dict[str, Any]:
        """The item of a :meth:`preprocess` result: the HPS on the device
        and its branch of the adaptation (TestDataset.py:232-287)."""
        img_icon, img_hps, mask, crop_param = processed[:4]
        out = self.hps(processed[4]) if self.hps_type == "bev" \
            else self.hps(torch.from_numpy(img_hps)[None])
        out = {k: v.cpu().numpy() if torch.is_tensor(v) else v
               for k, v in out.items()}
        item = {"name": name, "image": img_icon, "mask": mask,
                "crop_param": crop_param, "smpl_faces": self.hps.faces}
        betas = out.get("pred_shape")
        if self.hps_type == "pare":
            rotmat, verts, cam = (out["pred_pose"], out["smpl_vertices"],
                                  out["pred_cam"])
        elif self.hps_type == "hybrik":
            # the reference doubles HybrIK's scale (TestDataset.py:262)
            rotmat, verts = out["pred_theta_mats"], out["pred_vertices"]
            cam = out["pred_camera"] * np.array([2.0, 1.0, 1.0], np.float32)
        elif self.hps_type == "bev":            # adapted by BEVWrapper
            rotmat, verts, cam = out["rotmat"], out["verts"], out["cam"]
        elif self.hps_type == "pixie":
            # SMPL-X (TestDataset.py:248-254): the face and hand
            # parameters stay in the item
            for k in ("exp", "jaw_pose", "left_hand_pose",
                      "right_hand_pose"):
                item[k] = out[k]
            rotmat = np.concatenate([out["global_pose"], out["body_pose"]],
                                    axis=1)
            verts, cam, betas = out["vertices"], out["cam"], out["shape"]
        else:                                        # pymaf
            rotmat, verts, cam = out["rotmat"], out["verts"], out["pred_cam"]
        scale, tran_x, tran_y = (float(v) for v in np.asarray(cam)[0, :3])
        item.update({
            "betas": np.asarray(betas), "body_pose": rotmat[:, 1:],
            "global_orient": rotmat[:, 0:1], "smpl_verts": np.asarray(verts),
            "scale": scale,
            "trans": np.array([tran_x, tran_y, 0.0], np.float32)})
        return item

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.estimate(*self.preprocess(index))
