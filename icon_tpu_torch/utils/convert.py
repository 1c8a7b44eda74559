"""JAX package parameters -> the port's state dict.

:func:`state_dict_from_flax` turns ``icon_tpu``'s flax ``HGPIFuNet``
variables (as numpy arrays) into the torch state dict of
``icon_tpu_torch.models.hgpifu.HGPIFuNet``, so both packages can run the
same weights. The mapping is the inverse of
``icon_tpu/utils/torch_port.py``'s checkpoint port:

- Conv kernels HWIO -> OIHW; Dense (in, out) -> Conv1d (out, in, 1);
- norm ``scale``/``bias`` -> ``weight``/``bias``; batch stats ``mean``/
  ``var`` -> ``running_mean``/``running_var`` (+ ``num_batches_tracked``);
- MLP ``conv{i}``/``norm{i}`` -> ``filters.{i}``/``norms.{i}``;
- ConvBlock ``downsample`` -> ``downsample.2``, with ``bn4`` aliased as
  ``downsample.0``; a ConvBlock without a shortcut gets the identity
  ``bn4`` the reference registers anyway;
- the NormalNet's generators (``normal_filter/net{F,B}``) -> the
  reference's ``model.{i}`` Sequential indices: ``conv_in``, ``down{i}``,
  the ``nn.scan``-stacked ``res_stack`` (one leading axis of ``n_blocks``)
  split into ``model.{j}.conv_block.{1,5}``, ``up{i}/tconv`` (transposed
  conv, flax ``[kh, kw, O, I]`` -> torch ``[I, O, kh, kw]``) and
  ``conv_out``.

:func:`pymaf_state_from_flax` does the same for the JAX package's PyMAF
(the inverse of ``icon_tpu/models/pymaf/convert.py:_map_name``): backbone
``layer{s}_{i}`` -> ``layer{s}.{i}``, ``downsample_conv``/``downsample_bn``
-> ``downsample.0``/``downsample.1``; ``deconv{k}_tconv``/``deconv{k}_bn``
-> ``deconv_layers.{3k}``/``deconv_layers.{3k+1}``; ``maf_{i}`` ->
``maf_extractor.{i}`` (Dense (in, out) -> Conv1d (out, in, 1));
``regressor_{i}`` -> ``regressor.{i}`` (Dense -> Linear (out, in)).

:func:`body_model_from_jax` turns the JAX package's ``BodyModel`` into the
port's, array for array, so one body runs through both packages.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np

_CONVBLOCK = {"conv1", "conv2", "conv3", "bn1", "bn2", "bn3"}


def _flatten(tree: Any, prefix=()) -> Dict[tuple, np.ndarray]:
    if hasattr(tree, "items"):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: np.asarray(tree)}


def _module_path(path: tuple) -> list:
    """flax module names -> torch module names along one path."""
    mods = []
    in_mlp = False
    for name in path:
        if name == "if_regressor":
            in_mlp = True
        if in_mlp and name.startswith("conv") and name[4:].isdigit():
            mods += ["filters", name[4:]]
        elif in_mlp and name.startswith("norm") and name[4:].isdigit():
            mods += ["norms", name[4:]]
        elif name == "downsample":
            mods += ["downsample", "2"]
        else:
            mods.append(name)
    return mods


def _convert_kernel(w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:                      # HWIO -> OIHW
        return np.transpose(w, (3, 2, 0, 1))
    if w.ndim == 2:                      # Dense (in, out) -> Conv1d
        return np.transpose(w, (1, 0))[..., None]
    raise ValueError(f"unexpected kernel rank {w.ndim}")


def generator_state(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A flax ``GlobalGenerator`` params tree -> the reference's
    ``{prefix}model.{i}.*`` keys (see ``icon_tpu_torch.models.pix2pix``)."""
    n = sum(1 for k in tree if k.startswith("down"))
    stack = tree["res_stack"]
    nb = np.asarray(stack["conv1"]["kernel"]).shape[0]
    convs = [(1, tree["conv_in"]), (5 + 6 * n + nb, tree["conv_out"])]
    convs += [(4 + 3 * i, tree[f"down{i}"]) for i in range(n)]
    convs += [(f"{4 + 3 * n + j}.conv_block.{slot}",
               {k: np.asarray(v)[j] for k, v in stack[name].items()})
              for j in range(nb) for name, slot in (("conv1", 1),
                                                    ("conv2", 5))]
    out: Dict[str, np.ndarray] = {}
    for idx, p in convs:
        out[f"{prefix}model.{idx}.weight"] = _convert_kernel(
            np.asarray(p["kernel"]))
        out[f"{prefix}model.{idx}.bias"] = np.asarray(p["bias"])
    for i in range(n):
        p = tree[f"up{i}"]["tconv"]
        idx = 4 + 3 * n + nb + 3 * i
        # flax transpose_kernel layout [kh, kw, O, I] -> torch [I, O, kh, kw]
        out[f"{prefix}model.{idx}.weight"] = np.transpose(
            np.asarray(p["kernel"]), (3, 2, 0, 1))
        out[f"{prefix}model.{idx}.bias"] = np.asarray(p["bias"])
    return out


def state_dict_from_flax(params: Any, batch_stats: Optional[Any] = None
                         ) -> Dict[str, np.ndarray]:
    """``{torch key: numpy array}`` for the port's ``HGPIFuNet`` from flax
    ``params`` (and ``batch_stats``) trees. Without a ``normal_filter``
    scope (a flax init that was given the normal maps) the result fits an
    ``HGPIFuNet(cfg, normal_net=False)``."""
    out: Dict[str, np.ndarray] = {}
    for name, tree in params.get("normal_filter", {}).items():
        out.update(generator_state(tree, f"normal_filter.{name}."))
    params = {k: v for k, v in params.items() if k != "normal_filter"}
    for path, arr in _flatten(params).items():
        *mods, leaf = path
        key = ".".join(_module_path(tuple(mods)))
        if leaf == "kernel":
            out[f"{key}.weight"] = _convert_kernel(arr)
        elif leaf == "scale":
            out[f"{key}.weight"] = arr
        elif leaf == "bias":
            out[f"{key}.bias"] = arr
        else:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
    batch_norms = set()
    for path, arr in _flatten(batch_stats or {}).items():
        *mods, leaf = path
        key = ".".join(_module_path(tuple(mods)))
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise KeyError(f"unexpected flax batch stat {'/'.join(path)}")
        out[f"{key}.{names[leaf]}"] = arr
        batch_norms.add(key)
    for key in batch_norms:
        out[f"{key}.num_batches_tracked"] = np.array(0, np.int64)

    # ConvBlocks: alias bn4 as downsample.0, or add the unused identity bn4
    blocks = {}
    for path in _flatten(params):
        if len(path) < 2:
            continue
        blocks.setdefault(tuple(_module_path(path[:-2])),
                          set()).add(path[-2])
    for mods, children in blocks.items():
        if not _CONVBLOCK <= children:
            continue
        pre = "".join(m + "." for m in mods)
        bn4 = f"{pre}bn4."
        if "bn4" in children:
            for k in [k for k in out if k.startswith(bn4)]:
                out[f"{pre}downsample.0." + k[len(bn4):]] = out[k]
            continue
        bn1 = out[f"{pre}bn1.weight"]
        out[f"{bn4}weight"] = np.ones_like(bn1)
        out[f"{bn4}bias"] = np.zeros_like(bn1)
        if f"{pre}bn1" in batch_norms:
            out[f"{bn4}running_mean"] = np.zeros_like(bn1)
            out[f"{bn4}running_var"] = np.ones_like(bn1)
            out[f"{bn4}num_batches_tracked"] = np.array(0, np.int64)
    return out


def _pymaf_module(mods: tuple) -> str:
    """flax PyMAF module path -> the published checkpoint's module key."""
    out = []
    for name in mods:
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        d = re.fullmatch(r"deconv(\d)_(tconv|bn)", name)
        r = re.fullmatch(r"(maf|regressor)_(\d)", name)
        if m:
            out += [f"layer{m.group(1)}", m.group(2)]
        elif name in ("downsample_conv", "downsample_bn"):
            out += ["downsample", "0" if name.endswith("conv") else "1"]
        elif d:
            out += ["deconv_layers",
                    str(3 * int(d.group(1)) + (d.group(2) == "bn"))]
        elif r:
            out += ["maf_extractor" if r.group(1) == "maf" else "regressor",
                    r.group(2)]
        else:
            out.append(name)
    return ".".join(out)


def pymaf_state_from_flax(variables: Any) -> Dict[str, np.ndarray]:
    """``{torch key: numpy array}`` for the port's ``PyMAF`` from the JAX
    PyMAF's ``variables`` (``params`` and ``batch_stats``)."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(variables["params"]).items():
        *mods, leaf = path
        key = _pymaf_module(tuple(mods))
        if leaf == "kernel":
            if arr.ndim == 4 and mods[-1].endswith("_tconv"):
                # flax transpose_kernel [kh, kw, O, I] -> torch [I, O, kh, kw]
                w = np.transpose(arr, (3, 2, 0, 1))
            elif arr.ndim == 2 and mods[0].startswith("regressor_"):
                w = arr.T                           # Dense -> Linear
            else:
                w = _convert_kernel(arr)            # conv, Dense -> Conv1d
            out[f"{key}.weight"] = w
        elif leaf == "scale":
            out[f"{key}.weight"] = arr
        elif leaf == "bias":
            out[f"{key}.bias"] = arr
        else:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
    names = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _flatten(variables.get("batch_stats", {})).items():
        *mods, leaf = path
        key = _pymaf_module(tuple(mods))
        out[f"{key}.{names[leaf]}"] = arr
        out[f"{key}.num_batches_tracked"] = np.array(0, np.int64)
    return out


def body_model_from_jax(body: Any):
    """The port's ``BodyModel`` with the arrays (as numpy) and the static
    fields of ``icon_tpu``'s ``BodyModel`` ``body``."""
    from icon_tpu_torch.models.smplx.body import _ARRAYS, BodyModel
    arrays = {name: None if getattr(body, name) is None
              else np.asarray(getattr(body, name)) for name in _ARRAYS}
    return BodyModel(faces=np.asarray(body.faces), parents=body.parents,
                     model_type=body.model_type, num_betas=body.num_betas,
                     flat_hand_mean=body.flat_hand_mean, **arrays)
