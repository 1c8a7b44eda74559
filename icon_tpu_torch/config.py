"""The configuration tree the port reads (a copy of ``icon_tpu.config``'s
dataclasses and YAML loader: the same field names and defaults, which
mirror the reference's yacs tree, ``lib/common/config.py:21-162``, so the
reference's YAML configs parse unchanged).

Merge order as in the reference: defaults -> YAML file -> ``key value``
override list (``apps/infer.py:76-89``).
"""

from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


def _parse_channel_spec(value: Any) -> Tuple[Tuple[str, int], ...]:
    """Channel specs like ``(('normal_F',3), ('normal_B',3))``, which the
    reference's YAML stores as python-literal strings (``in_geo``,
    ``in_nml``)."""
    if value is None:
        return ()
    if isinstance(value, str):
        value = ast.literal_eval(value)
    return tuple((str(name), int(dim)) for name, dim in value)


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


_TUPLE_FIELDS = {
    "in_geo": _parse_channel_spec,
    "in_nml": _parse_channel_spec,
}


def _coerce(dc_cls, name: str, value: Any) -> Any:
    if name in _TUPLE_FIELDS:
        return _TUPLE_FIELDS[name](value)
    fields = {f.name: f for f in dataclasses.fields(dc_cls)}
    if fields.get(name) is None:
        return value
    # lists in YAML -> tuples in the tree
    if isinstance(value, list):
        return tuple(value)
    return value


def _merge_into(dc, updates: dict):
    """A copy of the dataclass ``dc`` with the dict ``updates`` merged in,
    recursively; keys the tree does not have are ignored (the reference's
    tree has many unused legacy options)."""
    changes = {}
    fields = {f.name: f for f in dataclasses.fields(dc)}
    for key, value in updates.items():
        if key not in fields:
            continue
        current = getattr(dc, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            changes[key] = _merge_into(current, value)
        else:
            changes[key] = _coerce(type(dc), key, value)
    return dataclasses.replace(dc, **changes)


def get_cfg_defaults() -> Config:
    return Config()


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[Sequence[Any]] = None,
                base: Optional[Config] = None) -> Config:
    """defaults -> YAML -> override list (alternating key and value, as in
    yacs)."""
    cfg = base if base is not None else Config()
    if yaml_path:
        import yaml
        with open(yaml_path) as f:
            data = yaml.safe_load(f) or {}
        cfg = _merge_into(cfg, data)
    if overrides:
        if len(overrides) % 2 != 0:
            raise ValueError("override list must alternate key value")
        for i in range(0, len(overrides), 2):
            key, value = str(overrides[i]), overrides[i + 1]
            if isinstance(value, str):
                try:
                    value = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    pass
            parts = key.split(".")
            node: dict = {}
            leaf = node
            for p in parts[:-1]:
                leaf[p] = {}
                leaf = leaf[p]
            leaf[parts[-1]] = value
            cfg = _merge_into(cfg, node)
    return cfg


def save_config(cfg: Config, path: str) -> None:
    """Write ``cfg`` as YAML that :func:`load_config` reads back to an equal
    config (tuples as lists)."""
    import yaml

    def lists(x):
        if isinstance(x, (tuple, list)):
            return [lists(v) for v in x]
        if isinstance(x, dict):
            return {k: lists(v) for k, v in x.items()}
        return x

    with open(path, "w") as f:
        yaml.safe_dump(lists(dataclasses.asdict(cfg)), f)
