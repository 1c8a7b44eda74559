"""The configuration tree the port reads (a copy of ``icon_tpu.config``'s
dataclasses: the same field names and defaults, which mirror the
reference's yacs tree, ``lib/common/config.py:21-162``).

The port builds its configs in code (:func:`icon_tpu_torch.recon.frame.
bench_config`); the YAML loader of the JAX package is not copied.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class NetConfig:
    """Network options (reference ``_C.net`` tree)."""

    gtype: str = "HGPIFuNet"
    norm: str = "group"           # image-filter norm: group | batch
    norm_mlp: str = "group"       # MLP norm: group | batch | instance | none
    hg_down: str = "ave_pool"     # ave_pool | conv64 | conv128
    # kernel_size, stride, dilation, padding
    conv1: Tuple[int, int, int, int] = (7, 2, 1, 3)
    conv3x3: Tuple[int, int, int, int] = (3, 1, 1, 1)
    num_stack: int = 4
    num_hourglass: int = 2
    hourglass_dim: int = 256
    voxel_dim: int = 32
    voxel_res: int = 128          # PaMIR semantic volume resolution
    mlp_dim: Tuple[int, ...] = (320, 1024, 512, 256, 128, 1)
    res_layers: Tuple[int, ...] = (2, 3, 4)
    smpl_dim: int = 3
    # icon | pamir | pifu; the reference's literal default is the legacy
    # 'sdf' (lib/common/config.py:105), which its code treats as pifu
    prior_type: str = "sdf"
    smpl_feats: Tuple[str, ...] = ("sdf", "cmap", "norm", "vis")
    use_filter: bool = True
    in_geo: Tuple[Tuple[str, int], ...] = ()
    in_nml: Tuple[Tuple[str, int], ...] = ()
    gan_mode: str = "none"
    # pix2pixHD generator sizes (reference define_G defaults,
    # NormalNet.py:67-70)
    ngf: int = 64
    n_downsampling: int = 4
    n_blocks: int = 9

    @property
    def in_geo_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.in_geo)

    @property
    def in_nml_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.in_nml)

    @property
    def in_geo_dim(self) -> int:
        return sum(d for _, d in self.in_geo)

    @property
    def in_nml_dim(self) -> int:
        return sum(d for _, d in self.in_nml)


@dataclass
class DatasetConfig:
    """Dataset options (reference ``_C.dataset`` tree)."""

    root: str = ""
    types: Tuple[str, ...] = ("thuman2",)
    scales: Tuple[float, ...] = (100.0,)
    th_type: str = "train"
    input_size: int = 512
    rotation_num: int = 3
    num_verts_max: int = 20000
    sigma_geo: float = 5.0
    num_sample_geo: int = 10000
    noise_type: Tuple[str, ...] = ("z-trans", "pose", "beta")
    noise_scale: Tuple[float, ...] = (0.0, 0.0, 0.0)
    online_smpl: bool = False
    zray_type: bool = False
    semantic_p: bool = False
    remove_outlier: bool = False
    train_bsize: float = 1.0
    val_bsize: float = 1.0
    test_bsize: float = 1.0
    set_splits: Tuple[float, ...] = (0.95, 0.04)


@dataclass
class Config:
    """Top-level config (reference ``_C`` tree)."""

    name: str = "default"
    root: str = "./data/"
    ckpt_dir: str = "./data/ckpt/"
    resume_path: str = ""
    normal_path: str = ""
    results_path: str = "./data/results/"
    projection_mode: str = "orthogonal"
    num_views: int = 1
    sdf: bool = False
    sdf_clip: float = 5.0

    lr_G: float = 1e-3
    lr_N: float = 2e-4
    weight_decay: float = 0.0
    momentum: float = 0.0
    optim: str = "RMSprop"
    schedule: Tuple[int, ...] = (5, 10, 15)
    gamma: float = 0.1

    overfit: bool = False
    resume: bool = False
    test_mode: bool = False
    mcube_res: int = 256
    clean_mesh: bool = True
    remesh: bool = False

    batch_size: int = 4
    num_threads: int = 8
    num_epoch: int = 10
    freq_plot: float = 0.01
    freq_show_train: float = 0.1
    freq_show_val: float = 0.2
    freq_eval: float = 0.5

    fast_dev: int = 0
    num_sanity_val_steps: int = 2

    # data-parallel device count (0 = all local devices)
    num_devices: int = 0

    net: NetConfig = field(default_factory=NetConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)
