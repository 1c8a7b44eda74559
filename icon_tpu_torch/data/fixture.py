"""A synthetic dataset on disk in the reference's layout
(``icon_tpu.data.fixture``).

:func:`make_synthetic_dataset` writes everything ``PIFuDataset`` reads —
scans, SMPL-X fit pickles, calibrated multi-view renders, normals,
visibility — from the synthetic SMPL-X stand-in, so the trainer and the
evaluator run end to end without licensed assets. The renders go through
``render_dataset.render_subject_views`` on the caller's device.
:func:`fixture_config` is a small config wired to it, :func:`train_config`
the reference's training recipe on it.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle

import numpy as np
import torch


def make_synthetic_dataset(root: str, dataset: str = "synth",
                           n_subjects: int = 2, n_views: int = 3,
                           size: int = 128, seed: int = 0,
                           vis_res: int = 1024, device="cuda") -> None:
    """Write ``{root}/{dataset}/...`` + ``{root}/{dataset}_{R}views/...``.

    ``vis_res`` defaults to 1024, not the reference's 4096 (the fixture
    feeds tests and loader runs)."""
    from icon_tpu_torch.data.datasets import vertex_normals_np
    from icon_tpu_torch.data.render_dataset import render_subject_views
    from icon_tpu_torch.models.smplx.assets import get_smpl_model
    from icon_tpu_torch.utils.io import save_obj

    rng = np.random.RandomState(seed)
    model = get_smpl_model()           # synthetic stand-in without assets
    rotations = list(range(0, 360, 360 // n_views))

    subjects = [f"{i:04d}" for i in range(n_subjects)]
    for split, subs in (("train", subjects), ("test", subjects[-1:]),
                        ("all", subjects)):
        os.makedirs(osp.join(root, dataset), exist_ok=True)
        with open(osp.join(root, dataset, f"{split}.txt"), "w") as f:
            f.write("\n".join(subs) + "\n")

    for si, subject in enumerate(subjects):
        param = {
            "betas": rng.randn(1, 10).astype(np.float32) * 0.3,
            "global_orient": rng.randn(1, 3).astype(np.float32) * 0.1,
            "body_pose": rng.randn(1, 63).astype(np.float32) * 0.1,
            "left_hand_pose": rng.randn(1, 12).astype(np.float32) * 0.1,
            "right_hand_pose": rng.randn(1, 12).astype(np.float32) * 0.1,
            "jaw_pose": np.zeros((1, 3), np.float32),
            "leye_pose": np.zeros((1, 3), np.float32),
            "reye_pose": np.zeros((1, 3), np.float32),
            "expression": rng.randn(1, 10).astype(np.float32) * 0.2,
            "scale": np.float64(1.0),
            "translation": np.zeros(3, np.float64),
        }
        fit_dir = osp.join(root, dataset, "fits", subject)
        os.makedirs(fit_dir, exist_ok=True)
        with open(osp.join(fit_dir, "smplx_param.pkl"), "wb") as f:
            pickle.dump(param, f)

        kw = ("betas", "global_orient", "body_pose", "left_hand_pose",
              "right_hand_pose", "expression")
        with torch.no_grad():
            body_verts, _ = model(**{k: torch.from_numpy(param[k])
                                     for k in kw})
        body_verts = body_verts[0].numpy()

        # the "scan": clothed = body inflated with smooth radial bumps
        vn = vertex_normals_np(body_verts, model.faces)
        bump = 0.02 + 0.015 * np.sin(6 * body_verts[:, 1] + si) * \
            np.cos(5 * body_verts[:, 0])
        scan_verts = (body_verts + vn * bump[:, None]).astype(np.float32)

        scan_dir = osp.join(root, dataset, "scans", subject)
        os.makedirs(scan_dir, exist_ok=True)
        save_obj(osp.join(scan_dir, f"{subject}.obj"), scan_verts,
                 model.faces)

        out_dir = osp.join(root, f"{dataset}_{n_views}views", subject)
        render_subject_views(out_dir, scan_verts, model.faces,
                             body_verts, model.faces, rotations,
                             size=size, seed=seed + si, vis_res=vis_res,
                             device=device)


def fixture_config(root: str, dataset: str = "synth", n_views: int = 3,
                   prior_type: str = "icon", num_sample_geo: int = 512,
                   image_size: int = 128):
    """A small Config wired to the fixture layout."""
    from icon_tpu_torch.config import Config, DatasetConfig, NetConfig
    return Config(
        name=f"fixture-{prior_type}",
        batch_size=2,
        num_threads=2,
        num_epoch=1,
        net=NetConfig(
            mlp_dim=(256, 128, 1), res_layers=(1,), num_stack=1,
            num_hourglass=1, hourglass_dim=6, smpl_dim=7, voxel_dim=7,
            prior_type=prior_type, use_filter=True,
            in_geo=(("normal_F", 3), ("normal_B", 3)),
            in_nml=(("image", 3), ("T_normal_F", 3), ("T_normal_B", 3)),
            smpl_feats=("sdf", "cmap", "norm", "vis"),
            voxel_res=32,
            norm_mlp="batch", ngf=4, n_downsampling=2, n_blocks=1),
        dataset=DatasetConfig(
            root=root, types=(dataset,), scales=(1.0,),
            rotation_num=n_views, num_sample_geo=num_sample_geo,
            input_size=image_size,
            noise_type=("pose", "beta"), noise_scale=(0.01, 0.05)))


def train_config(root: str, ckpt_dir: str = "", prior: str = "icon",
                 num_epoch: int = 10):
    """The reference's training recipe (configs/train/icon-filter.yaml:
    52-76; the JAX package's scripts/bench_train.py): a 2-stack hourglass,
    the BatchNorm MLP 13 -> 512 -> 256 -> 128 -> 1 through
    ``mlp_first_dim``, batch 4, 512^2 inputs, 8,000 samples an item, 4
    loader workers, on a :func:`make_synthetic_dataset` root with 3 views
    and ``fixture_config``'s pose and shape noise; pamir with its 128^3
    volume and 32 features."""
    from icon_tpu_torch.config import Config, DatasetConfig, NetConfig
    return Config(
        name=f"train-{prior}", ckpt_dir=ckpt_dir, batch_size=4,
        num_threads=4, num_epoch=num_epoch, mcube_res=256,
        net=NetConfig(
            mlp_dim=(256, 512, 256, 128, 1), res_layers=(2, 3, 4),
            num_stack=2, prior_type=prior, use_filter=True,
            in_geo=(("normal_F", 3), ("normal_B", 3)),
            in_nml=(("image", 3), ("T_normal_F", 3), ("T_normal_B", 3)),
            smpl_feats=("sdf", "norm", "vis", "cmap"), norm_mlp="batch",
            hourglass_dim=6, smpl_dim=7),
        dataset=DatasetConfig(
            root=root, types=("synth",), scales=(1.0,), rotation_num=3,
            num_sample_geo=8000, input_size=512,
            noise_type=("pose", "beta"), noise_scale=(0.01, 0.05)))
