"""Person box and matte for in-the-wild RGB photos (a numpy copy of
``icon_tpu.models.detector``; reference lib/pymaf/utils/imutils.py:34-47,
89-136, which crops with an external detector and mattes inside the crop).

:func:`saliency_person_bbox` combines spectral-residual saliency (Hou &
Zhang, CVPR 2007) with a border-contrast cue and takes the largest
connected component's box; it stands in for the trained YOLOv3-tiny
detector (``models/yolo.py``) when that finds nobody or its weights are not
installed. The matte inside the box comes from the U^2-Net matting net
(``models/u2net.py``) when installed, else from the soft border-contrast
figure/ground estimate, with a warning.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _resize_np(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize through PIL's uint8 path (host preprocessing)."""
    from PIL import Image
    arr = Image.fromarray((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))
    out = arr.resize((hw[1], hw[0]), Image.BILINEAR)
    return np.asarray(out, np.float32) / 255.0


def spectral_residual_saliency(rgb: np.ndarray,
                               work: int = 64) -> np.ndarray:
    """[H, W, 3] in [0, 1] -> [H, W] saliency in [0, 1]."""
    H, W = rgb.shape[:2]
    gray = _resize_np(rgb, (work, work)).mean(-1)
    spec = np.fft.fft2(gray)
    log_amp = np.log(np.abs(spec) + 1e-9)
    phase = np.angle(spec)
    # local average of the log spectrum (3x3 box)
    k = np.ones((3, 3)) / 9.0
    pad = np.pad(log_amp, 1, mode="edge")
    avg = sum(pad[i:i + work, j:j + work] * k[i, j]
              for i in range(3) for j in range(3))
    residual = log_amp - avg
    sal = np.abs(np.fft.ifft2(np.exp(residual + 1j * phase))) ** 2
    # smooth + normalize
    pad = np.pad(sal, 2, mode="edge")
    sal = sum(pad[i:i + work, j:j + work]
              for i in range(5) for j in range(5)) / 25.0
    sal = (sal - sal.min()) / (sal.max() - sal.min() + 1e-9)
    return _resize_np(sal[..., None].repeat(3, -1), (H, W))[..., 0]


def _largest_component_bbox(mask: np.ndarray):
    """(y0, x0, y1, x1) of the largest 4-connected true component (flood
    fill on the coarse grid), or None when ``mask`` is empty."""
    from collections import deque
    H, W = mask.shape
    seen = np.zeros_like(mask, bool)
    best, best_n = None, 0
    for sy in range(H):
        for sx in range(W):
            if not mask[sy, sx] or seen[sy, sx]:
                continue
            q = deque([(sy, sx)])
            seen[sy, sx] = True
            ys, xs, n = [sy], [sx], 1
            while q:
                y, x = q.popleft()
                for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    ny, nx = y + dy, x + dx
                    if 0 <= ny < H and 0 <= nx < W and mask[ny, nx] \
                            and not seen[ny, nx]:
                        seen[ny, nx] = True
                        q.append((ny, nx))
                        ys.append(ny)
                        xs.append(nx)
                        n += 1
            if n > best_n:
                best_n = n
                best = (min(ys), min(xs), max(ys), max(xs))
    return best


def border_contrast_saliency(rgb: np.ndarray, work: int = 64,
                             band: int = 6) -> np.ndarray:
    """[H, W, 3] -> [work, work] figure/ground cue: the colour distance from
    the border band's mean colour (the background usually touches the frame
    edge, the person usually does not)."""
    small = _resize_np(rgb, (work, work))
    border = np.concatenate([
        small[:band].reshape(-1, 3), small[-band:].reshape(-1, 3),
        small[:, :band].reshape(-1, 3), small[:, -band:].reshape(-1, 3)])
    mean = border.mean(0)
    d = np.linalg.norm(small - mean, axis=-1)
    return (d - d.min()) / (d.max() - d.min() + 1e-9)


def saliency_person_bbox(rgb: np.ndarray, thresh: float = 1.0,
                         margin: float = 0.15,
                         work: int = 64) -> Tuple[int, int, int, int]:
    """[H, W, 3] -> (y0, x0, y1, x1) person box estimate: both cues
    averaged, thresholded at mean + ``thresh`` * std, dilated 3x3, the
    largest component expanded by ``margin``; the full frame when nothing
    is salient."""
    H, W = rgb.shape[:2]
    sal = spectral_residual_saliency(rgb, work)
    coarse = _resize_np(sal[..., None].repeat(3, -1),
                        (work, work))[..., 0]
    coarse = coarse / (coarse.max() + 1e-9)
    coarse = 0.5 * coarse + 0.5 * border_contrast_saliency(rgb, work)
    mask = coarse > coarse.mean() + thresh * coarse.std()
    # 3x3 dilation closes small gaps so the person labels as one component
    p = np.pad(mask, 1)
    mask = (p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
            | p[1:-1, 1:-1])
    box = _largest_component_bbox(mask)
    if box is None:
        return 0, 0, H, W
    y0, x0, y1, x1 = box
    sy, sx = H / coarse.shape[0], W / coarse.shape[1]
    y0, y1 = int(y0 * sy), int((y1 + 1) * sy)
    x0, x1 = int(x0 * sx), int((x1 + 1) * sx)
    my = int((y1 - y0) * margin)
    mx = int((x1 - x0) * margin)
    return (max(y0 - my, 0), max(x0 - mx, 0),
            min(y1 + my, H), min(x1 + mx, W))


def detect_and_matte(rgb: np.ndarray,
                     segmenter: Optional[callable] = None,
                     detector: Optional[callable] = None,
                     thresh: float = 0.35,
                     stages: Optional[Dict[str, float]] = None
                     ) -> np.ndarray:
    """Full RGB frame -> person alpha ``[H, W]`` (the reference's detector,
    then the matte inside its box, imutils.py:89-136).

    The trained detector (a :class:`~icon_tpu_torch.models.yolo.
    PersonDetector`, when given) proposes the box; the saliency box stands
    in when there is none or it finds nobody. With a ``segmenter`` the
    matte comes from it, else from the soft border-contrast estimate, with
    a warning that the result is degraded (a hard box alpha would make
    every silhouette loss fit a rectangle). ``stages`` (optional) gains
    the seconds spent in ``detect`` and ``matte``."""
    import time
    import warnings

    clock = time.perf_counter()
    H, W = rgb.shape[:2]
    box = None
    if detector is not None:
        from icon_tpu_torch.models.yolo import person_bbox
        box = person_bbox(detector, rgb)
    if box is None:
        box = saliency_person_bbox(rgb, thresh=thresh)
    y0, x0, y1, x1 = box
    if stages is not None:
        now = time.perf_counter()
        stages["detect"] = stages.get("detect", 0.0) + now - clock
        clock = now
    alpha = np.zeros((H, W), np.float32)
    crop = rgb[y0:y1, x0:x1]
    if segmenter is not None:
        alpha[y0:y1, x0:x1] = np.asarray(segmenter(crop), np.float32)
    else:
        warnings.warn(
            "no matting checkpoint installed (data/HPS/u2net.pth) — using "
            "a saliency figure/ground estimate as the person matte; "
            "silhouette-driven stages will be degraded", stacklevel=2)
        soft = border_contrast_saliency(crop, work=96)
        soft = np.where(soft > soft.mean(), soft, 0.0)
        alpha[y0:y1, x0:x1] = _resize_np(
            soft[..., None].repeat(3, -1), crop.shape[:2])[..., 0]
    if stages is not None:
        stages["matte"] = stages.get("matte", 0.0) + \
            time.perf_counter() - clock
    return alpha
