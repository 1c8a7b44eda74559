"""JAX package parameters -> the port's state dict.

:func:`state_dict_from_flax` turns ``icon_tpu``'s flax ``HGPIFuNet``
variables (as numpy arrays) into the torch state dict of
``icon_tpu_torch.models.hgpifu.HGPIFuNet``, so both packages can run the
same weights. The mapping is the inverse of
``icon_tpu/utils/torch_port.py``'s checkpoint port:

- Conv kernels HWIO -> OIHW and DHWIO -> OIDHW (PaMIR's volume encoder,
  ``ve.*``); Dense (in, out) -> Conv1d (out, in, 1);
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

:func:`pixie_state_from_flax` and :func:`hybrik_state_from_flax` do the
same for the JAX package's PIXIE and HybrIK (the inverses of
``icon_tpu/models/pixie/convert.py`` and ``icon_tpu/models/hybrik/
convert.py``), into the published files' names: ``encoder_body`` ->
``Encoder_body.encoder`` with the HRNet's ``layer1_{k}``, ``t{n}_conv``/
``t{n}_bn`` -> ``transition{n}.*``, ``stage{s}_{m}/branch{b}_block{k}`` ->
``stage{s}.{m}.branches.{b}.{k}``, ``fuse{i}_{j}_conv[{k}]`` ->
``fuse_layers.{i}.{j}.[{k}.]0``, ``subsample{S}_conv{k}`` ->
``subsample_{S}.{3k}``, ``convlayers_{i}`` -> ``conv_layers.{i}`` (its
``downsample_conv`` a bare ``downsample``); ``regressor_*``,
``extractor_*`` and ``moderator_*`` -> ``Regressor_*``, ... with
``layers_{i}`` -> ``layers.{i}``; HybrIK's ``deconv{k}``/``deconv_bn{k}``
-> ``deconv_layers.{3k}``/``{3k+1}`` and its ``init_shape`` parameter ->
the buffer of that name.

:func:`train_state_from_flax` turns a JAX ``TrainState`` (its params,
batch_stats and optax state, as numpy) into the port's model state dict and
:class:`~icon_tpu_torch.training.train_step.Optimizer` state: each
parameter-shaped tree of the optax state (RMSprop's ``nu`` and ``trace``,
Adam's ``mu`` and ``nu``, SGD's ``trace``) goes through the parameters'
own mapping, and the schedule's and Adam's step counts carry over, so both
packages train on from the same point.

:func:`normal_state_from_flax` does the same for the JAX package's
``NormalTrainState`` (the generators ``net{F,B}``, Adam's ``mu`` and ``nu``
and both counts), and :func:`vgg19_state_from_flax` turns its
``Vgg19Features`` params back into torchvision's names.

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
    if w.ndim == 5:                      # DHWIO -> OIDHW
        return np.transpose(w, (4, 3, 0, 1, 2))
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


def _state_from_flax(variables: Any, module_key, weight) -> Dict[str,
                                                                np.ndarray]:
    """A torch state dict from flax ``variables``: ``module_key(path)`` the
    torch module of a flax module path, ``weight(path, kernel)`` the torch
    weight of a kernel."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(variables["params"]).items():
        *mods, leaf = path
        key = module_key(tuple(mods))
        if leaf == "kernel":
            out[f"{key}.weight"] = weight(tuple(mods), arr)
        elif leaf == "scale":
            out[f"{key}.weight"] = arr
        elif leaf in ("bias", "temperature", "init_shape"):
            out[f"{key}.{leaf}" if key else leaf] = arr
        else:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
    names = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _flatten(variables.get("batch_stats", {})).items():
        *mods, leaf = path
        key = module_key(tuple(mods))
        out[f"{key}.{names[leaf]}"] = arr
        out[f"{key}.num_batches_tracked"] = np.array(0, np.int64)
    return out


# one flax module name of the HRNet -> its torch key (PIXIE's body encoder)
_HRNET_NAMES = (
    (r"layer1_(\d+)", r"layer1.\1"),
    (r"stage(\d)_(\d+)", r"stage\1.\2"),
    (r"branch(\d)_block(\d+)", r"branches.\1.\2"),
    (r"fuse(\d)_(\d)_conv", r"fuse_layers.\1.\2.0"),
    (r"fuse(\d)_(\d)_bn", r"fuse_layers.\1.\2.1"),
    (r"fuse(\d)_(\d)_conv(\d)", r"fuse_layers.\1.\2.\3.0"),
    (r"fuse(\d)_(\d)_bn(\d)", r"fuse_layers.\1.\2.\3.1"),
    (r"t1_conv0", "transition1.0.0"), (r"t1_bn0", "transition1.0.1"),
    (r"t1_conv1", "transition1.1.0.0"), (r"t1_bn1", "transition1.1.0.1"),
    (r"t([23])_conv", r"transition\1.\1.0.0"),
    (r"t([23])_bn", r"transition\1.\1.0.1"),
    (r"convlayers_(\d)", r"conv_layers.\1"),
    (r"downsample_bn", "downsample.1"),
)


def _pixie_module(mods: tuple) -> str:
    """flax PIXIE module path -> the published file's ``module.key``."""
    top, rest = mods[0], mods[1:]
    out = [top[0].upper() + top[1:]]
    if top == "encoder_body":
        out.append("encoder")
        head = any(n.startswith("convlayers_") for n in rest)
        for name in rest:
            sub = re.fullmatch(r"subsample(\d)_(conv|bn)(\d)", name)
            if sub:
                out.append(f"subsample_{sub.group(1)}."
                           f"{3 * int(sub.group(3)) + (sub.group(2) == 'bn')}")
                continue
            if name == "downsample_conv":
                out.append("downsample" if head else "downsample.0")
                continue
            for pat, rep in _HRNET_NAMES:
                if re.fullmatch(pat, name):
                    name = re.sub(pat, rep, name)
                    break
            out.append(name)
    elif top.startswith("encoder_"):
        out += ["encoder", _pymaf_module(rest)] if rest else ["encoder"]
    else:
        out += [re.sub(r"layers_(\d+)", r"layers.\1", n) for n in rest
                if n != "layers"]
    return ".".join(n for n in out if n)


def pixie_state_from_flax(variables: Any) -> Dict[str, np.ndarray]:
    """``{torch key: numpy array}`` for the port's ``PIXIE`` from the JAX
    PIXIE's ``variables`` (``params`` and ``batch_stats``)."""
    def weight(mods, arr):
        return arr.T if arr.ndim == 2 else _convert_kernel(arr)
    return _state_from_flax(variables, _pixie_module, weight)


def _hybrik_module(mods: tuple) -> str:
    if not mods:
        return ""
    d = re.fullmatch(r"deconv(_bn)?(\d)", mods[0])
    if d:
        return f"deconv_layers.{3 * int(d.group(2)) + bool(d.group(1))}"
    if mods[0] == "preact":
        return ".".join(("preact", _pymaf_module(mods[1:])))
    return _pymaf_module(mods)


def hybrik_state_from_flax(variables: Any) -> Dict[str, np.ndarray]:
    """``{torch key: numpy array}`` for the port's ``HybrIK`` from the JAX
    HybrIK's ``variables`` (``params`` and ``batch_stats``)."""
    def weight(mods, arr):
        if arr.ndim == 2:
            return arr.T                            # Dense -> Linear
        if mods[0].startswith("deconv"):
            # flax transpose_kernel [kh, kw, O, I] -> torch [I, O, kh, kw]
            return np.transpose(arr, (3, 2, 0, 1))
        return _convert_kernel(arr)
    return _state_from_flax(variables, _hybrik_module, weight)


def body_model_from_jax(body: Any):
    """The port's ``BodyModel`` with the arrays (as numpy) and the static
    fields of ``icon_tpu``'s ``BodyModel`` ``body``."""
    from icon_tpu_torch.models.smplx.body import _ARRAYS, BodyModel
    arrays = {name: None if getattr(body, name) is None
              else np.asarray(getattr(body, name)) for name in _ARRAYS}
    return BodyModel(faces=np.asarray(body.faces), parents=body.parents,
                     model_type=body.model_type, num_betas=body.num_betas,
                     flat_hand_mean=body.flat_hand_mean, **arrays)


def _optax_leaves(opt_state: Any, found: dict) -> None:
    """Collect the optax state's parameter-shaped trees and counts: optax
    states are named tuples (``ScaleByRmsState(nu)``,
    ``ScaleByScheduleState(count)``, ``TraceState(trace)``,
    ``ScaleByAdamState(count, mu, nu)``, ``EmptyState()``) nested in
    chains' tuples."""
    fields = getattr(opt_state, "_fields", None)
    if fields is None:
        if isinstance(opt_state, (tuple, list)):
            for sub in opt_state:
                _optax_leaves(sub, found)
        return
    kind = type(opt_state).__name__
    for name in fields:
        value = getattr(opt_state, name)
        if name == "count":
            found["adam_count" if kind == "ScaleByAdamState"
                  else "count"] = int(np.asarray(value))
        elif name in ("nu", "mu", "trace"):
            found[name] = value
        else:
            _optax_leaves(value, found)


def train_state_from_flax(params: Any, batch_stats: Any, opt_state: Any,
                          optimizer) -> Dict[str, np.ndarray]:
    """Load a JAX ``TrainState``'s optax state into the port's
    ``optimizer`` (built for the same config) and return the model's state
    dict (as :func:`state_dict_from_flax`). A parameter without a JAX
    counterpart keeps zero state; the identity ``bn4`` of a ConvBlock
    without a shortcut gets the mapping's filler, and never a gradient."""
    import torch
    found: dict = {}
    _optax_leaves(opt_state, found)
    sd = {"kind": optimizer.kind, "count": found.get("count", 0),
          "adam_count": found.get("adam_count", 0), "state": {}}
    trees = {k: state_dict_from_flax(found[k])
             for k in ("nu", "mu", "trace") if k in found}
    for name, st in optimizer.state.items():
        sd["state"][name] = {
            k: (torch.from_numpy(np.ascontiguousarray(trees[k][name]))
                if name in trees.get(k, {}) else torch.zeros_like(v))
            for k, v in st.items()}
    optimizer.load_state_dict(sd)
    return state_dict_from_flax(params, batch_stats)


def normal_state_from_flax(params: Any, opt_state: Any = None,
                           optimizer=None) -> Dict[str, np.ndarray]:
    """The port's ``NormalNet`` state dict from a JAX ``NormalTrainState``'s
    ``params`` (``net{F,B}`` at the top level, each through
    :func:`generator_state`); with ``opt_state`` and the port's Adam
    ``optimizer`` (``training/normal_step.py:make_normal_optimizer``), its
    ``mu`` and ``nu`` through the same mapping and both step counts are
    loaded into ``optimizer``."""
    def mapped(tree):
        out: Dict[str, np.ndarray] = {}
        for name, sub in tree.items():
            out.update(generator_state(sub, f"{name}."))
        return out

    if opt_state is not None and optimizer is not None:
        import torch
        found: dict = {}
        _optax_leaves(opt_state, found)
        trees = {k: mapped(found[k]) for k in ("mu", "nu")}
        optimizer.load_state_dict({
            "kind": optimizer.kind, "count": found.get("count", 0),
            "adam_count": found.get("adam_count", 0),
            "state": {name: {k: torch.tensor(np.asarray(trees[k][name]))
                             for k in st}
                for name, st in optimizer.state.items()}})
    return mapped(params)


def vgg19_state_from_flax(params: Any) -> Dict[str, np.ndarray]:
    """The port's ``Vgg19Features`` state dict (torchvision's
    ``features.{i}`` names) from the JAX package's ``Vgg19Features`` params
    (``conv{i}``, HWIO kernels): the inverse of
    ``icon_tpu/models/vgg.py:port_vgg19``."""
    out: Dict[str, np.ndarray] = {}
    for name, p in params.items():
        i = int(name[len("conv"):])
        out[f"features.{i}.weight"] = _convert_kernel(np.asarray(p["kernel"]))
        out[f"features.{i}.bias"] = np.asarray(p["bias"])
    return out
