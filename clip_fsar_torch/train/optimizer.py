"""Learning-rate policies, the reference's parameter groups, and the
optimizer (counterpart of clip_fsar_tpu/train/optimizer.py:39-157, 201-358).

The LR policies and the grouping are the JAX package's own arithmetic on the
reference's parameter names (``"head." +`` the port's names, which follow
the reference's torch names).  ``Optimizer`` is the JAX transformation chain
as torch optimizers over param groups, in the same order:

    clip_by_global_norm (TRAIN.CLIP_GRAD_NORM)
    -> torch-L2 decay added to the gradient before the moments (adam, sgd;
       SOLVER.WEIGHT_DECAY for the 'rest'/'head' groups, BN.WEIGHT_DECAY
       for 'bn') or decoupled after them (adamw)
    -> Adam (b1 0.9, b2 0.999, eps 1e-8), AdamW, SGD with momentum, or LARS
       (its group's decay inside the trust ratio, ``Lars``)
    -> 1/10 lr for the 'bn' and 'rest' groups under LR_REDUCE and FINE_TUNE
    -> frozen parameters (FIXED_WEIGHTS, ONLY_LINEAR, BN.WB_LOCK) never move,

accumulated over TRAIN.BATCH_SIZE_PER_TASK micro-steps with the semantics of
the JAX ``cond_multi_steps``: gradients are summed, divided by k on the k-th
micro-step, and the update uses the lr of that emitting step.
``TPU.FLAT_OPTIMIZER`` is a TPU layout choice with no effect on the numbers
and is not read.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from clip_fsar_torch.parallel import tensor
from clip_fsar_torch.utils import tracing

# ---------------------------------------------------------------------------
# LR policies (reference lr_policy.py:10-56)
# ---------------------------------------------------------------------------


def lr_cosine(cfg, cur_epoch: float) -> float:
    s = cfg.SOLVER
    return float(s.BASE_LR) * (math.cos(math.pi * cur_epoch / float(s.MAX_EPOCH)) + 1.0) * 0.5


def lr_steps_with_relative_lrs(cfg, cur_epoch: float) -> float:
    s = cfg.SOLVER
    steps = list(s.STEPS) + [s.MAX_EPOCH]
    ind = 0
    for ind, step in enumerate(steps):
        if cur_epoch < step:
            break
    return float(s.LRS[ind - 1]) * float(s.BASE_LR)


_POLICIES = {"cosine": lr_cosine, "steps_with_relative_lrs": lr_steps_with_relative_lrs}


def get_lr_at_epoch(cfg, cur_epoch: float) -> float:
    """Policy LR with linear warmup below WARMUP_EPOCHS."""
    policy = _POLICIES[cfg.SOLVER.LR_POLICY]
    lr = policy(cfg, cur_epoch)
    warmup = float(cfg.SOLVER.get("WARMUP_EPOCHS", 0))
    if cur_epoch < warmup:
        lr_start = float(cfg.SOLVER.WARMUP_START_LR)
        lr_end = policy(cfg, warmup)
        lr = cur_epoch * (lr_end - lr_start) / warmup + lr_start
    return lr


def epoch_for_iter(cfg, cur_iter: int) -> float:
    """The lr epoch of global iteration ``cur_iter``, as the reference's
    few-shot trainer computes it (train_net_few_shot.py:58,65,95):
    i // STEPS_ITER + NUM_FOLDS * i / STEPS_ITER.  The fractional term makes
    the schedule advance at about 2i/STEPS_ITER for NUM_FOLDS = 1, a
    reference quirk the JAX package keeps (optimizer.py:69-80)."""
    steps_iter = int(cfg.SOLVER.get("STEPS_ITER", 1) or 1)
    cur_epoch = cur_iter // steps_iter
    num_folds = int(cfg.TRAIN.get("NUM_FOLDS", 1))
    return cur_epoch + num_folds * float(cur_iter) / max(steps_iter, 1)


# ---------------------------------------------------------------------------
# parameter groups (reference models/utils/optimizer.py:43-83)
# ---------------------------------------------------------------------------


# OpenAI's names of an RN bottleneck's shortcut -> the JAX package's: its BatchNorm must land in the 'bn' group
_DOWNSAMPLE = {"0": "downsample_conv", "1": "downsample_bn"}


def _reference_name_parts(parts: List[str]) -> List[str]:
    """Drop flax norm-wrapper segments under a CLIP ``ln_*`` module (the
    JAX package's rule; the port's names have none), and name an RN
    shortcut's ``downsample.0`` / ``downsample.1`` as the JAX package does
    (``downsample_conv`` / ``downsample_bn``), so each name is grouped as
    its JAX counterpart is (optimizer.py:95-125)."""
    out = []
    for i, p in enumerate(parts):
        if p.startswith(("layernorm_", "batchnorm_", "groupnorm_")) and i > 0 and parts[i - 1].startswith("ln"):
            continue
        if p == "downsample" and parts[i + 1 : i + 2] and parts[i + 1] in _DOWNSAMPLE:
            continue
        out.append(_DOWNSAMPLE[p] if i > 0 and parts[i - 1] == "downsample" and p in _DOWNSAMPLE else p)
    return out


def classify_param(parts: List[str]) -> str:
    """Reference grouping, same elif order, substring matching:
    'no_decay' ("embd"/"cls_token", wd 0), 'bn' ("bn"/"norm",
    BN.WEIGHT_DECAY, lr-reduced), 'head' ("head", full wd, never
    lr-reduced), 'rest' (full wd, lr-reduced)."""
    name = ".".join(_reference_name_parts(parts))
    if "embd" in name or "cls_token" in name:
        return "no_decay"
    if "bn" in name or "norm" in name:
        return "bn"
    if "head" in name:
        return "head"
    return "rest"


def _name_parts(name: str, name_prefix: str) -> List[str]:
    parts = name.lower().split(".")
    return (name_prefix.lower().split("/") + parts) if name_prefix else parts


def param_groups(names, name_prefix: str = "head") -> Dict[str, str]:
    """{parameter name: group label}.  ``name_prefix`` positions the names
    inside the reference's model namespace (few-shot heads live under
    ``head.``, so with it every CLIP ``ln_*`` weight is decayed and
    ``context2.norm_*`` is not, as in the reference)."""
    return {n: classify_param(_name_parts(n, name_prefix)) for n in names}


def fixed_params(cfg, names, name_prefix: str = "head") -> set:
    """Names of frozen parameters: TRAIN.FIXED_WEIGHTS matches the first two
    components of the reference name, TRAIN.ONLY_LINEAR freezes all but
    'head' names (reference optimizer.py:50-57)."""
    fixed = set(cfg.TRAIN.get("FIXED_WEIGHTS", []) or []) if "TRAIN" in cfg else set()
    only_linear = bool(cfg.TRAIN.get("ONLY_LINEAR", False)) if "TRAIN" in cfg else False
    out = set()
    for n in names:
        parts = _name_parts(n, name_prefix)
        if any(p in fixed for p in parts[:2]) or (only_linear and "head" not in ".".join(_reference_name_parts(parts))):
            out.add(n)
    return out


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


class Lars(torch.optim.Optimizer):
    """LARS with the JAX package's math (scale_by_lars, optimizer.py:159-198;
    reference models/utils/lars.py:75-117), per parameter tensor p with
    gradient g and its group's weight decay wd:

        local_lr = trust * ||p|| / (||g|| + wd * ||p||)   (1 where ||p|| or ||g|| is 0)
        d = (g + wd * p) * local_lr
        buf = momentum * buf + d
        p -= lr * (d + momentum * buf if nesterov else buf)

    with the raw gradient's norm, and the lr applied after the transformation
    (the JAX package's stated divergence from the reference, which
    multiplies each step's lr into the buffer).  The norms are the full
    tensors' under tensor parallelism.  As the fused torch
    optimizers here, a step with ``found_inf`` 1 changes nothing, decided on
    the device."""

    def __init__(self, params, momentum: float = 0.9, trust_coefficient: float = 0.001, nesterov: bool = False):
        super().__init__(params, {"lr": 0.0, "momentum": momentum, "trust_coefficient": trust_coefficient, "nesterov": nesterov,
                                  "weight_decay": 0.0})
        self.found_inf: Optional[torch.Tensor] = None
        self.grad_scale = None
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["momentum_buffer"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            wd, mom, trust = group["weight_decay"], group["momentum"], group["trust_coefficient"]
            for p in group["params"]:
                ok = torch.ones((), dtype=torch.bool, device=p.device) if self.found_inf is None else self.found_inf == 0
                g, buf = p.grad, self.state[p]["momentum_buffer"]
                p_norm, g_norm = tensor.tensor_norm(p, p), tensor.tensor_norm(g, p)
                local_lr = torch.where((p_norm > 0) & (g_norm > 0), trust * p_norm / (g_norm + wd * p_norm), torch.ones_like(p_norm))
                d = (g + wd * p) * local_lr
                new_buf = mom * buf + d
                upd = d + mom * new_buf if group["nesterov"] else new_buf
                buf.copy_(torch.where(ok, new_buf, buf))
                p.sub_(torch.where(ok, group["lr"] * upd, torch.zeros_like(upd)))
        return None


class Optimizer:
    """The JAX optimizer chain over a module's parameters (see the module
    docstring).  ``step(lr, ok)`` takes the gradients in the parameters'
    ``.grad`` as one micro-step and returns, as a 0-dim bool tensor on the
    parameters' device, whether it applied an update.

    Nothing in a step is decided on the host, as in the JAX chain (its NaN
    guard and its accumulation window are ``lax.cond``s): ``ok`` (0-dim bool
    on the device, False for a step to skip) gates the window's sums and its
    micro-step count, which is a device scalar too, and the update itself is
    torch's fused optimizer with ``found_inf`` set unless the window closes
    on this step -- the fused kernels then leave parameters and moments
    alone and take the step count back.  Every micro-step therefore launches
    the same kernels, and none waits for the card.

    Under tensor parallelism (parallel/tensor.py) a sharded parameter's
    moments are its slice's: the clipping norm and LARS's norms sum over
    the model group, the signature names the full shapes, and
    ``state_dict`` gathers the slices into full tensors.  An optimizer made
    before its module was sharded takes the slices with ``follow_shards``."""

    def __init__(self, cfg, module: nn.Module, name_prefix: str = "head"):
        with tracing.setup_span("fsar.setup.state"):  # the train state's optimizer part (train/state.py)
            self._make(cfg, module, name_prefix)

    def _make(self, cfg, module: nn.Module, name_prefix: str) -> None:
        s = cfg.SOLVER
        self.method = str(s.get("OPTIM_METHOD", "adam"))
        wd = float(s.get("WEIGHT_DECAY", 0.0) or 0.0)
        bn_wd = float(cfg.BN.get("WEIGHT_DECAY", 0.0) or 0.0) if "BN" in cfg else 0.0
        wb_lock = bool(cfg.BN.get("WB_LOCK", False)) if "BN" in cfg else False
        lr_reduce = bool(cfg.TRAIN.get("LR_REDUCE", False)) and bool(cfg.TRAIN.get("FINE_TUNE", False)) if "TRAIN" in cfg else False
        clip = cfg.TRAIN.get("CLIP_GRAD_NORM", None) if "TRAIN" in cfg else None
        self.clip_norm = float(clip) if clip else None
        self.k = int(cfg.TRAIN.get("BATCH_SIZE_PER_TASK", 1)) if "TRAIN" in cfg else 1

        named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]  # every trained parameter: accumulation and clipping see them all
        groups = param_groups([n for n, _ in named], name_prefix)
        frozen = fixed_params(cfg, [n for n, _ in named], name_prefix)
        if wb_lock:
            frozen |= {n for n, g in groups.items() if g == "bn"}
        if self.method in ("adam", "sgd"):
            decay = {"rest": wd, "head": wd, "bn": bn_wd, "no_decay": 0.0}
        elif self.method == "adamw":  # decoupled decay for the decay mask only
            decay = {"rest": wd, "head": wd, "bn": 0.0, "no_decay": 0.0}
        elif self.method == "lars":  # decay inside the rule, per group: folding it into the gradient would change ||g||
            decay = {"rest": wd, "head": wd, "bn": bn_wd, "no_decay": 0.0}
        else:
            raise NotImplementedError(f"Unsupported OPTIM_METHOD {self.method!r}")

        buckets: Dict[tuple, List[nn.Parameter]] = {}
        for n, p in named:
            if n in frozen:
                continue
            g = groups[n]
            key = (g, decay[g], 0.1 if (lr_reduce and g in ("bn", "rest")) else 1.0)
            buckets.setdefault(key, []).append(p)
        param_groups_ = [{"params": ps, "weight_decay": wd_, "lr_scale": scale, "group": g} for (g, wd_, scale), ps in buckets.items()]
        if self.method == "adam":
            self.inner = torch.optim.Adam(param_groups_, lr=0.0, betas=(0.9, 0.999), eps=1e-8, fused=True)
        elif self.method == "adamw":
            self.inner = torch.optim.AdamW(param_groups_, lr=0.0, betas=(0.9, 0.999), eps=1e-8, fused=True)
        elif self.method == "lars":
            self.inner = Lars(param_groups_, momentum=float(s.get("MOMENTUM", 0.9)), nesterov=bool(s.get("NESTEROV", False)))
        else:
            self.inner = torch.optim.SGD(
                param_groups_, lr=0.0, momentum=float(s.get("MOMENTUM", 0.9)), nesterov=bool(s.get("NESTEROV", False)), dampening=0.0,
                fused=True,
            )
        self.device = self.params[0].device if self.params else torch.device("cpu")
        self.mini_step = torch.zeros((), dtype=torch.int64, device=self.device)  # micro-steps in the open window (k > 1)
        self.acc: Optional[List[torch.Tensor]] = None  # gradient sums of the open window (k > 1)
        self._zero_missing_momentum()

    def signature(self) -> dict:
        """What a checkpointed optimizer state must match to be restored."""
        return {
            "method": self.method,
            "k": self.k,
            "groups": [(g["group"], g["weight_decay"], g["lr_scale"], [tensor.full_shape(p) for p in g["params"]])
                       for g in self.inner.param_groups],
        }

    def _zero_missing_momentum(self) -> None:
        """Fused SGD creates a momentum buffer on its first call without
        filling it when that call is skipped; a zero buffer gives the same
        first update (momentum * 0 + gradient), skipped calls or not.  Done
        once, when the state is made or loaded: no step walks the state."""
        if self.method != "sgd" or not self.inner.defaults["momentum"]:
            return
        for group in self.inner.param_groups:
            for p in group["params"]:
                if self.inner.state[p].get("momentum_buffer") is None:
                    self.inner.state[p]["momentum_buffer"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, lr: float, ok: Optional[torch.Tensor] = None) -> torch.Tensor:
        if ok is None:
            ok = torch.ones((), dtype=torch.bool, device=self.device)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        do_update = ok
        if self.k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            # a skipped step adds zeros: selected, not multiplied (NaN * 0 is NaN)
            torch._foreach_add_(self.acc, [torch.where(ok, g, 0.0) for g in grads])
            self.mini_step += ok
            do_update = ok & (self.mini_step == self.k)
            grads = torch._foreach_div(self.acc, float(self.k))
            keep = ~do_update  # the window closes: sums and count start over
            torch._foreach_mul_(self.acc, keep.to(torch.float32))
            self.mini_step *= keep
        if self.clip_norm is not None:  # optax.clip_by_global_norm
            norm = tensor.global_norm(grads, self.params)
            scale = torch.where(norm < self.clip_norm, torch.ones_like(norm), self.clip_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.inner.param_groups:
            group["lr"] = lr * group["lr_scale"]
        self.inner.grad_scale = None
        self.inner.found_inf = (~do_update).to(torch.float32)  # 1.: the fused step changes nothing
        self.inner.step()
        return do_update

    def _inner_params(self) -> List[nn.Parameter]:
        return [p for g in self.inner.param_groups for p in g["params"]]  # the order of the inner state dict's indices

    def state_dict(self) -> dict:
        """Full tensors (every model rank calls it when the parameters are sharded)."""
        inner, acc = self.inner.state_dict(), self.acc
        if any(tensor.spec(p) is not None for p in self.params):
            full = lambda t, p: tensor.spec(p).gather(t) if (tensor.spec(p) is not None and t.shape == p.shape) else t  # noqa: E731
            ps = self._inner_params()
            inner["state"] = {i: {k: full(v, ps[i]) for k, v in st.items()} for i, st in inner["state"].items()}
            acc = None if acc is None else [full(a, p) for a, p in zip(acc, self.params)]
        return {"inner": inner, "mini_step": int(self.mini_step), "acc": acc, "signature": self.signature()}

    @torch.no_grad()
    def follow_shards(self) -> None:
        """Cut the moments and the accumulation window of every sharded
        parameter to its slice (after ``parallel.tensor.shard_module``)."""
        take = lambda t, p: tensor.spec(p).take(t) if (tensor.spec(p) is not None and tuple(t.shape) == tensor.full_shape(p)) else t  # noqa: E731
        for p in self._inner_params():
            st = self.inner.state.get(p, {})
            for k, v in st.items():
                if torch.is_tensor(v):
                    st[k] = take(v, p)
        if self.acc is not None:
            self.acc = [take(a, p) for a, p in zip(self.acc, self.params)]

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd["inner"])
        self._zero_missing_momentum()
        self.mini_step.fill_(int(sd["mini_step"]))
        self.acc = None if sd["acc"] is None else [a.to(p.device) for a, p in zip(sd["acc"], self.params)]
