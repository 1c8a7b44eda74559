"""U^2-Net salient-object matting (``icon_tpu.models.u2net``; the reference's
``rembg`` background removal, lib/pymaf/utils/imutils.py:11,132-136).

Nested residual U-blocks (RSU-7..RSU-4 and the dilated RSU-4F) in a
6-stage encoder and decoder, six side outputs fused by a 1x1 conv. The
module names are the public checkpoints' (``stageN[d].rebnconvX[d].
conv_s1/bn_s1``, ``sideN``, ``outconv``), so ``u2net.pth`` (full, 44M
parameters) and ``u2netp.pth`` (lite, 1.1M) load with ``load_state_dict``.

Two choices follow the JAX package rather than the public net: the 2x2
max pools floor (the public net's ``ceil_mode=True`` agrees at the
segmenter's 320^2 input, where every size stays even), and the upsampling
is bilinear with half-pixel centres (``align_corners=False``, which is
``jax.image.resize``'s bilinear when it upsamples).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class REBNCONV(nn.Module):
    """3x3 conv (dilation ``dirate``) -> BatchNorm -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int, dirate: int = 1):
        super().__init__()
        self.conv_s1 = nn.Conv2d(in_ch, out_ch, 3, padding=dirate,
                                 dilation=dirate)
        self.bn_s1 = nn.BatchNorm2d(out_ch)

    def forward(self, x):
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _up_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Bilinear upsample of ``x`` to ``ref``'s spatial size."""
    if x.shape[2:] == ref.shape[2:]:
        return x
    return F.interpolate(x, size=ref.shape[2:], mode="bilinear",
                         align_corners=False)


def _pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class RSU(nn.Module):
    """Residual U-block of height ``height`` (RSU-7 .. RSU-4)."""

    def __init__(self, height: int, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.height = height
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch)
        for i in range(2, height):
            self.add_module(f"rebnconv{i}", REBNCONV(mid_ch, mid_ch))
        self.add_module(f"rebnconv{height}", REBNCONV(mid_ch, mid_ch, 2))
        for i in range(height - 1, 1, -1):
            self.add_module(f"rebnconv{i}d", REBNCONV(2 * mid_ch, mid_ch))
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch)

    def forward(self, x):
        L = self.height
        hxin = self.rebnconvin(x)
        enc = [self.rebnconv1(hxin)]
        h = enc[0]
        for i in range(2, L):
            h = getattr(self, f"rebnconv{i}")(_pool(h))
            enc.append(h)
        h = getattr(self, f"rebnconv{L}")(enc[-1])
        for i in range(L - 1, 1, -1):
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, enc[i - 1]], 1))
            h = _up_to(h, enc[i - 2])
        h = self.rebnconv1d(torch.cat([h, enc[0]], 1))
        return h + hxin


class RSU4F(nn.Module):
    """The dilation-only residual block (no pooling)."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.rebnconvin = REBNCONV(in_ch, out_ch)
        self.rebnconv1 = REBNCONV(out_ch, mid_ch, 1)
        self.rebnconv2 = REBNCONV(mid_ch, mid_ch, 2)
        self.rebnconv3 = REBNCONV(mid_ch, mid_ch, 4)
        self.rebnconv4 = REBNCONV(mid_ch, mid_ch, 8)
        self.rebnconv3d = REBNCONV(2 * mid_ch, mid_ch, 4)
        self.rebnconv2d = REBNCONV(2 * mid_ch, mid_ch, 2)
        self.rebnconv1d = REBNCONV(2 * mid_ch, out_ch, 1)

    def forward(self, x):
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        h3d = self.rebnconv3d(torch.cat([h4, h3], 1))
        h2d = self.rebnconv2d(torch.cat([h3d, h2], 1))
        return self.rebnconv1d(torch.cat([h2d, h1], 1)) + hxin


# (block type, height, mid, out) per stage: the encoder's six, then the
# decoder's five (stage5d .. stage1d); u2net full and lite (u2netp)
U2NET_FULL = (
    ("rsu", 7, 32, 64), ("rsu", 6, 32, 128), ("rsu", 5, 64, 256),
    ("rsu", 4, 128, 512), ("rsu4f", 0, 256, 512), ("rsu4f", 0, 256, 512),
    ("rsu4f", 0, 256, 512), ("rsu", 4, 128, 256), ("rsu", 5, 64, 128),
    ("rsu", 6, 32, 64), ("rsu", 7, 16, 64),
)
U2NET_LITE = (
    ("rsu", 7, 16, 64), ("rsu", 6, 16, 64), ("rsu", 5, 16, 64),
    ("rsu", 4, 16, 64), ("rsu4f", 0, 16, 64), ("rsu4f", 0, 16, 64),
    ("rsu4f", 0, 16, 64), ("rsu", 4, 16, 64), ("rsu", 5, 16, 64),
    ("rsu", 6, 16, 64), ("rsu", 7, 16, 64),
)


def _block(spec, in_ch: int) -> nn.Module:
    kind, height, mid, out = spec
    if kind == "rsu":
        return RSU(height, in_ch, mid, out)
    return RSU4F(in_ch, mid, out)


class U2NET(nn.Module):
    """``x [B, H, W, 3]`` -> the fused saliency ``[B, H, W, 1]`` in [0, 1]
    (channel-last at the boundary, as the JAX module)."""

    def __init__(self, config: Sequence = U2NET_LITE):
        super().__init__()
        cfg = tuple(config)
        outs = [spec[3] for spec in cfg]
        ins = [3] + outs[:5]                          # stage1 .. stage6
        for i in range(6):
            self.add_module(f"stage{i + 1}", _block(cfg[i], ins[i]))
        for i in range(5):                            # stage5d .. stage1d
            skip = outs[4 - i]
            below = outs[5] if i == 0 else outs[5 + i]
            self.add_module(f"stage{5 - i}d", _block(cfg[6 + i],
                                                     below + skip))
        # side{k} reads d_k: stage1d .. stage5d, then stage6
        side_in = [outs[10 - k] for k in range(5)] + [outs[5]]
        for k in range(6):
            self.add_module(f"side{k + 1}", nn.Conv2d(side_in[k], 1, 3,
                                                      padding=1))
        self.outconv = nn.Conv2d(6, 1, 1)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The fused logit and the six side logits before the sigmoid,
        ``[B, 7, H, W]`` (fused first), from ``x [B, H, W, 3]``."""
        x = x.permute(0, 3, 1, 2)
        encs: List[torch.Tensor] = []
        h = x
        for i in range(6):
            h = getattr(self, f"stage{i + 1}")(h)
            encs.append(h)
            if i < 5:
                h = _pool(h)
        sides = [encs[5]]
        h = _up_to(encs[5], encs[4])
        for i in range(5):
            h = getattr(self, f"stage{5 - i}d")(torch.cat([h, encs[4 - i]],
                                                          1))
            sides.append(h)
            if i < 4:
                h = _up_to(h, encs[3 - i])
        outs = [_up_to(getattr(self, f"side{k + 1}")(s), x)
                for k, s in enumerate(reversed(sides))]
        d = torch.cat(outs, 1)
        return torch.cat([self.outconv(d), d], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.logits(x)[:, :1]).permute(0, 2, 3, 1)


SEG_SIZE = 320


def segmenter_input(rgb: np.ndarray) -> np.ndarray:
    """The host side before the net: ``[H, W, 3]`` in [0, 1] -> ``[320,
    320, 3]`` through PIL's uint8 bilinear resize, normalized by the
    image's own mean and std (not ImageNet's)."""
    from PIL import Image
    small = np.asarray(Image.fromarray(
        (np.clip(rgb, 0, 1) * 255).astype(np.uint8)).resize(
            (SEG_SIZE, SEG_SIZE), Image.BILINEAR), np.float32) / 255.0
    mean = small.mean(axis=(0, 1), keepdims=True)
    std = small.std(axis=(0, 1), keepdims=True) + 1e-6
    return (small - mean) / std


def segmenter_output(alpha: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """The host side after the net: the ``[320, 320]`` alpha back to
    ``hw`` through a uint8 round trip and PIL's bilinear resize."""
    from PIL import Image
    H, W = hw
    return np.asarray(Image.fromarray(
        (alpha * 255).astype(np.uint8)).resize(
            (W, H), Image.BILINEAR), np.float32) / 255.0


def build_u2net(lite: bool = True) -> U2NET:
    """U^2-Net (``U2NET_LITE`` or ``U2NET_FULL``) in eval mode, its random
    initialization drawn under seed 0 (the caller's generator is
    untouched)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = U2NET(U2NET_LITE if lite else U2NET_FULL)
    return net.eval()


class Segmenter:
    """Callable ``[H, W, 3]`` float in [0, 1] -> alpha ``[H, W]``: the
    net on ``device``, the host pre- and post-processing of the JAX
    segmenter."""

    def __init__(self, net: U2NET, device="cuda"):
        self.device = torch.device(device)
        self.net = net.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, rgb: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(segmenter_input(rgb))[None].to(self.device)
        alpha = self.net(x)[0, ..., 0].cpu().numpy()
        return segmenter_output(alpha, rgb.shape[:2])


def build_segmenter(ckpt_path: str, lite: bool = True,
                    device="cuda") -> Segmenter:
    """The matting callable of the checkpoint ``ckpt_path`` (``u2net.pth``
    or ``u2netp.pth``, a plain state dict) on ``device`` (the card unless
    the caller asks for the CPU). The load is strict: a file that is
    missing or does not fit raises."""
    net = build_u2net(lite)
    state = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    net.load_state_dict(state.get("state_dict", state), strict=True)
    return Segmenter(net, device)
