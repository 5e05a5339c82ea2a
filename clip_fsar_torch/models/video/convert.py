"""The JAX package's video-model variables -> the port's state dict
(counterpart of nothing in the JAX package: the route for weights it
trained, through its ``.npz`` archives, and for the parity tests).

The port's module names are the flax ones (models/video/blocks.py), so the
mapping is per leaf:

* a conv ``kernel`` [kt, kh, kw, in / groups, out] -> ``weight`` [out,
  in / groups, kt, kh, kw] (grouped convs, CSN and RouteFuncMLP, keep flax's
  per-group input axis, which is torch's), and so for every rank: the
  localization task's grouped Conv1d [k, in / groups, out] -> [out,
  in / groups, k] (SimpleLocalizationConv, BaseBMN's 1-D convs), BaseBMN's
  (N, 1, 1) Conv3d and its 2-D convs HWIO -> OIHW (the confidence,
  regression and verb / noun branches; train/localization.py's BMNModel
  names them ``backbone.conv_<i>`` and ``head.x_*`` as flax does);
* a Dense ``kernel`` (in, out) -> ``weight`` (out, in) (the classifiers,
  MoSINet's ``net.head.out_<axis>`` among them);
* the JAX package's BatchNorm (``BatchNorm_0/{scale, bias}`` and
  ``batch_stats/.../BatchNorm_0/{mean, var}``) and flax's own ``nn.BatchNorm``
  (``b_avgpool_bn``: {scale, bias} and {mean, var} one level higher) ->
  ``weight``, ``bias``, ``running_mean``, ``running_var``;
* a LayerNorm's {scale, bias} -> ``weight``, ``bias``;
* class tokens and position tables as they are.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from clip_fsar_torch.models.clip.convert import _t


def _walk(out: Dict[str, torch.Tensor], prefix: str, tree: Mapping, stats: Optional[Mapping]) -> None:
    join = (lambda name: f"{prefix}.{name}") if prefix else (lambda name: name)  # noqa: E731
    if "kernel" in tree:
        k = _t(tree["kernel"])
        out[join("weight")] = (k.T if k.dim() == 2 else k.permute(k.dim() - 1, k.dim() - 2, *range(k.dim() - 2))).contiguous()
        if "bias" in tree:
            out[join("bias")] = _t(tree["bias"])
        return
    if "BatchNorm_0" in tree:
        tree, stats = tree["BatchNorm_0"], None if stats is None else stats.get("BatchNorm_0")
    if set(tree) == {"scale", "bias"}:
        out[join("weight")], out[join("bias")] = _t(tree["scale"]), _t(tree["bias"])
        if stats is not None and "mean" in stats:
            out[join("running_mean")], out[join("running_var")] = _t(stats["mean"]), _t(stats["var"])
        return
    for name, sub in tree.items():
        if isinstance(sub, Mapping):
            _walk(out, join(name), sub, None if stats is None else stats.get(name))
        else:
            out[join(name)] = _t(sub)


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} of the JAX ``build_video_model``
    (numpy leaves) -> the port's ``BaseVideoModel`` (or MoSINet) state dict,
    and {"params": ...} of the JAX localization ``BMNModel`` -> the port's
    ``BMNModel`` one; without ``batch_stats`` the running statistics are
    left out."""
    out: Dict[str, torch.Tensor] = {}
    _walk(out, "", variables["params"], variables.get("batch_stats"))
    return out
