"""YOLOv3-tiny person detector (``icon_tpu.models.yolo``; the reference crops
with a trained person detector before matting, lib/pymaf/utils/imutils.py:
34-47 ``get_bbox`` through the ``human_det`` package).

The published COCO YOLOv3-tiny (class 0 = person), loaded from the darknet
``yolov3-tiny.weights`` binary itself: installed at
``data/HPS/yolov3-tiny.weights``, RGB photos get a trained person box;
without it the dataset takes the weight-free saliency box of
``models/detector.py``.

13 convolutions at a fixed 416^2 input, BatchNorm folded into each conv at
load (eps 1e-5, as the standard torch ports of darknet); the boxes decode
on the device, the threshold and NMS run on the host.
"""

from __future__ import annotations

import struct as _struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# darknet yolov3-tiny.cfg's convolutions: (darknet layer index, in_ch,
# out_ch, ksize, batchnorm). The maxpool, route, upsample and yolo layers
# carry no weights and are wired in the forward; in_ch follows the graph
# (conv18 reads the 256-channel l13 route, conv21 the 128 + 256 concat).
CONV_LAYERS: List[Tuple[int, int, int, int, bool]] = [
    (0, 3, 16, 3, True), (2, 16, 32, 3, True), (4, 32, 64, 3, True),
    (6, 64, 128, 3, True), (8, 128, 256, 3, True), (10, 256, 512, 3, True),
    (12, 512, 1024, 3, True), (13, 1024, 256, 1, True),
    (14, 256, 512, 3, True), (15, 512, 255, 1, False),
    (18, 256, 128, 1, True), (21, 384, 256, 3, True),
    (22, 256, 255, 1, False),
]

# anchors in net-input pixels; the 13x13 head takes mask 3,4,5 and the
# 26x26 head mask 1,2,3 (the yolov3-tiny cfg's quirk)
ANCHORS = np.array([(10, 14), (23, 27), (37, 58),
                    (81, 82), (135, 169), (344, 319)], np.float32)
MASKS = ((3, 4, 5), (1, 2, 3))
NET_SIZE = 416
N_CLASSES = 80
BN_EPS = 1e-5


class YoloTiny(nn.Module):
    """The YOLOv3-tiny forward with BatchNorm folded into the convolutions
    (``conv{idx}.weight``/``.bias``, the darknet layer indices): ``x [N,
    416, 416, 3]`` -> the raw heads ``[N, 13, 13, 255]`` and ``[N, 26, 26,
    255]``, channel-last as the JAX module's."""

    def __init__(self):
        super().__init__()
        for idx, cin, ch, k, _ in CONV_LAYERS:
            self.add_module(f"conv{idx}",
                            nn.Conv2d(cin, ch, k, padding=k // 2))

    def _conv(self, idx: int, h: torch.Tensor, act: bool = True):
        h = getattr(self, f"conv{idx}")(h)
        return F.leaky_relu(h, 0.1) if act else h

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        def pool(h):
            return F.max_pool2d(h, 2, 2)

        h = self._conv(0, x.permute(0, 3, 1, 2))
        h = self._conv(2, pool(h))
        h = self._conv(4, pool(h))
        h = self._conv(6, pool(h))
        l8 = self._conv(8, pool(h))                  # 26x26x256 route point
        h = self._conv(10, pool(l8))
        # maxpool size 2 stride 1: zero-pad right and bottom (after the
        # leaky ReLU, so zero and not -inf), then a VALID 2x2 max
        h = F.max_pool2d(F.pad(h, (0, 1, 0, 1)), 2, 1)
        h = self._conv(12, h)
        l13 = self._conv(13, h)                      # 13x13x256 route point
        head1 = self._conv(15, self._conv(14, l13), act=False)
        h = self._conv(18, l13)
        h = h.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        h = torch.cat([h, l8], dim=1)                # route -1, 8
        head2 = self._conv(22, self._conv(21, h), act=False)
        return head1.permute(0, 2, 3, 1), head2.permute(0, 2, 3, 1)


def decode_head(head: torch.Tensor, mask: Tuple[int, int, int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[N, G, G, 255]`` -> (boxes ``[N, G*G*3, 4]`` cxcywh in [0, 1] of the
    net input, person score ``[N, G*G*3]``): sigmoid offsets and the
    anchors' exp sizes (the standard YOLOv3 decode; person = COCO class
    0)."""
    N, G = head.shape[0], head.shape[1]
    p = head.reshape(N, G, G, 3, 5 + N_CLASSES)
    ar = torch.arange(G, device=head.device, dtype=head.dtype)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    cx = (torch.sigmoid(p[..., 0]) + gx[None, :, :, None]) / G
    cy = (torch.sigmoid(p[..., 1]) + gy[None, :, :, None]) / G
    anc = torch.as_tensor(ANCHORS[list(mask)] / NET_SIZE, device=head.device)
    bw = anc[:, 0] * torch.exp(p[..., 2])
    bh = anc[:, 1] * torch.exp(p[..., 3])
    score = torch.sigmoid(p[..., 4]) * torch.sigmoid(p[..., 5])
    boxes = torch.stack([cx, cy, bw, bh], dim=-1)
    return boxes.reshape(N, -1, 4), score.reshape(N, -1)


def _decode_all(heads) -> Tuple[torch.Tensor, torch.Tensor]:
    parts = [decode_head(h, m) for h, m in zip(heads, MASKS)]
    return (torch.cat([b for b, _ in parts], dim=1),
            torch.cat([s for _, s in parts], dim=1))


# ---------------------------------------------------------------------------
# darknet .weights parsing (host numpy)


def parse_darknet_weights(blob: bytes) -> Dict[str, Dict[str, np.ndarray]]:
    """Raw darknet buffer -> per-conv arrays in file order.

    Format: a header (3 x int32 version, then the images seen as int64 for
    version >= 0.2, else int32), then for each conv layer in cfg order
    [bn_beta, bn_gamma, bn_mean, bn_var] (or conv_bias without BN), then
    the conv weights [out, in, k, k]."""
    major, minor = _struct.unpack("<ii", blob[:8])
    off = 12 + (8 if major * 10 + minor >= 2 else 4)
    data = np.frombuffer(blob, np.float32, offset=off)
    pos = 0

    def take(n):
        nonlocal pos
        out = data[pos:pos + n]
        if len(out) != n:
            raise ValueError("darknet weights file truncated")
        pos += n
        return out.copy()

    out: Dict[str, Dict[str, np.ndarray]] = {}
    for idx, cin, ch, k, bn in CONV_LAYERS:
        d: Dict[str, np.ndarray] = {}
        if bn:
            d["beta"] = take(ch)
            d["gamma"] = take(ch)
            d["mean"] = take(ch)
            d["var"] = take(ch)
        else:
            d["bias"] = take(ch)
        d["weight"] = take(ch * cin * k * k).reshape(ch, cin, k, k)
        out[f"conv{idx}"] = d
    if pos != len(data):
        raise ValueError(
            f"darknet weights length mismatch: {len(data) - pos} floats left")
    return out


def fold_to_params(raw: Dict[str, Dict[str, np.ndarray]]
                   ) -> Dict[str, torch.Tensor]:
    """Fold BatchNorm into each conv (scale = gamma / sqrt(var + eps), in
    float32 numpy as the JAX package does) -> :class:`YoloTiny`'s state
    dict (``conv{idx}.weight [out, in, k, k]``, ``conv{idx}.bias``)."""
    state = {}
    for name, d in raw.items():
        w = d["weight"].astype(np.float32)
        if "gamma" in d:
            scale = d["gamma"] / np.sqrt(d["var"] + BN_EPS)
            w = w * scale[:, None, None, None]
            b = d["beta"] - d["mean"] * scale
        else:
            b = d["bias"]
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        state[f"{name}.bias"] = torch.from_numpy(b.astype(np.float32))
    return state


def load_darknet(path: str) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        return fold_to_params(parse_darknet_weights(f.read()))


# ---------------------------------------------------------------------------
# the detection front end (host)


def _letterbox(rgb: np.ndarray) -> Tuple[np.ndarray, float, int, int]:
    """``[H, W, 3]`` in [0, 1] -> (``[416, 416, 3]``, scale, pad_y, pad_x)."""
    from PIL import Image
    H, W = rgb.shape[:2]
    s = NET_SIZE / max(H, W)
    nh, nw = int(round(H * s)), int(round(W * s))
    im = Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8))
    small = np.asarray(im.resize((nw, nh), Image.BILINEAR),
                       np.float32) / 255.0
    out = np.full((NET_SIZE, NET_SIZE, 3), 0.5, np.float32)
    py, px = (NET_SIZE - nh) // 2, (NET_SIZE - nw) // 2
    out[py:py + nh, px:px + nw] = small
    return out, s, py, px


def _nms(boxes: np.ndarray, scores: np.ndarray, iou: float = 0.45
         ) -> List[int]:
    order = np.argsort(-scores)
    keep: List[int] = []
    x0 = boxes[:, 0] - boxes[:, 2] / 2
    y0 = boxes[:, 1] - boxes[:, 3] / 2
    x1 = boxes[:, 0] + boxes[:, 2] / 2
    y1 = boxes[:, 1] + boxes[:, 3] / 2
    area = (x1 - x0) * (y1 - y0)
    while len(order):
        i = order[0]
        keep.append(int(i))
        if len(order) == 1:
            break
        rest = order[1:]
        iw = np.maximum(0, np.minimum(x1[i], x1[rest])
                        - np.maximum(x0[i], x0[rest]))
        ih = np.maximum(0, np.minimum(y1[i], y1[rest])
                        - np.maximum(y0[i], y0[rest]))
        inter = iw * ih
        order = rest[inter / (area[i] + area[rest] - inter + 1e-9) <= iou]
    return keep


class PersonDetector:
    """Trained person detection, RGB frame -> boxes, the net on ``device``
    (the card unless the caller asks for the CPU).

    ``__call__(rgb)`` returns (boxes ``[K, 4]`` as (y0, x0, y1, x1) in the
    frame's pixels, scores ``[K]``) after the threshold and NMS, best
    first. The reference's ``get_bbox`` averages all detections into one
    box (imutils.py:34-47); this keeps a box per person, and the crop takes
    the best."""

    def __init__(self, weights_path: str, thresh: float = 0.25,
                 device="cuda"):
        self.device = torch.device(device)
        self.thresh = thresh
        self.net = YoloTiny()
        self.net.load_state_dict(load_darknet(weights_path), strict=True)
        self.net.to(self.device).eval()

    @torch.no_grad()
    def heads(self, inp: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """The raw heads of one letterboxed ``[416, 416, 3]`` input."""
        return self.net(torch.from_numpy(inp)[None].to(self.device))

    def __call__(self, rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        H, W = rgb.shape[:2]
        inp, s, py, px = _letterbox(rgb)
        boxes, scores = (a[0].cpu().numpy()
                         for a in _decode_all(self.heads(inp)))
        sel = scores > self.thresh
        boxes, scores = boxes[sel] * NET_SIZE, scores[sel]
        if not len(boxes):
            return np.zeros((0, 4), np.float32), np.zeros(0, np.float32)
        keep = _nms(boxes, scores)
        boxes, scores = boxes[keep], scores[keep]
        # undo the letterbox -> the frame's pixels, clamped
        cx = (boxes[:, 0] - px) / s
        cy = (boxes[:, 1] - py) / s
        bw, bh = boxes[:, 2] / s, boxes[:, 3] / s
        out = np.stack([np.clip(cy - bh / 2, 0, H),
                        np.clip(cx - bw / 2, 0, W),
                        np.clip(cy + bh / 2, 0, H),
                        np.clip(cx + bw / 2, 0, W)], -1)
        return out.astype(np.float32), scores


def person_bbox(detector: PersonDetector, rgb: np.ndarray,
                margin: float = 0.1
                ) -> Optional[Tuple[int, int, int, int]]:
    """The best person's (y0, x0, y1, x1) with ``margin``, or None when
    nobody is detected (the caller takes the saliency box)."""
    boxes, scores = detector(rgb)
    if not len(boxes):
        return None
    y0, x0, y1, x1 = boxes[0]
    my, mx = (y1 - y0) * margin, (x1 - x0) * margin
    H, W = rgb.shape[:2]
    return (int(max(y0 - my, 0)), int(max(x0 - mx, 0)),
            int(min(y1 + my, H)), int(min(x1 + mx, W)))
