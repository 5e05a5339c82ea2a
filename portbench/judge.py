"""How ``correct`` is decided: the reference recomputes what the timed path produced, from the
same inputs, and each number compared is held to its limit in the cell's file.  The head's
reference is the configuration's family's (``portbench/families/<family>.py``: a train step's
loss and gradient, a test episode's logits); the optimizer, the readings and the verdict here
serve every family.

Train cells (the first ``check_steps`` steps, which set-up ran through the window's own loop
body, step and feed; with ``BATCH_SIZE_PER_TASK`` 4 they are one optimizer window, closed by
one update): ``loss_gap``, the largest gap of a step's loss to the reference's, over the
reference's; ``grad_gap``, the first gradient as the optimizer holds it after one step, by the
worst leaf: the gap between the program's norm of the leaf and the reference's, over the larger
of the reference's norm of that leaf and of the median leaf (``grad_norm_gap``: the gap of the
whole gradient's norm, over the reference's); ``moment_gap`` and ``moment2_gap``, the same for
Adam's first and second moments after the window's update, which hold the window's mean
gradient (every step of it, with the decay) and its square (``moment_norm_gap``,
``moment2_norm_gap``: the whole moment's norm); ``change_gap``, the same for each leaf's
change after the window, leaving out the leaves whose mean gradient in the reference is under
a thousandth of the median leaf's (they move by round-off alone); ``descent_gap``, how far the
descent of the program's change along the reference's first moment falls from the reference's
own over those leaves: ``|1 - <program change, m> / <reference change, m>|``, 2 for an update of
the opposite sign (Adam's first update is about the learning rate times the sign of each
gradient, so where bf16 rounding flips the sign of a gradient near 0 the change flips, and the
weight of the moment keeps those elements from counting for more than they move the loss).
A packed q | k | v in-projection counts as its three leaves (``unpacked``).  Test cells:
``logit_gap``, the largest gap of a logit to the reference's over the mean size of the
reference's logits, over a sample of the window's episodes drawn from the seed.  Every cell:
``bad_rows``, the clips whose bank rows, crops or labels break the episode's contract (every
frame a row of one video of the labelled class, crops inside the stretched frame), which has
to be 0.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np
import torch

from portbench.inputs import Inputs
from portbench.reference.ops import Precision, no_tf32
from portbench.reference.train import Adam, decay_of, learning_rate


def bad_rows(table: dict, rows: np.ndarray, real: np.ndarray, local: np.ndarray, num_frames: int, crop: int = 0,
             frame_hw: tuple = (0, 0)) -> int:
    """Clips of one episode's field whose rows [N, T(+3)] break the contract; ``real`` and
    ``local`` their real and episode-local labels [N]."""
    f = table["frames"]
    bad = 0
    for clip, r, loc in zip(np.asarray(rows), np.asarray(real), np.asarray(local)):
        frames = clip[:num_frames].astype(np.int64)
        v = int(frames[0]) // f
        ok = 0 <= v < len(table["paths"]) and int(table["classes"][v]) == int(r)
        ok = ok and bool(np.all((frames >= v * f) & (frames < v * f + int(table["nframes"][v]))))
        if crop:
            y, x, flip = (int(c) for c in clip[num_frames:num_frames + 3])
            ok = ok and 0 <= y <= frame_hw[0] - crop and 0 <= x <= frame_hw[1] - crop and flip in (0, 1)
        bad += 0 if ok else 1
    return bad


def episode_bad_rows(table: dict, ep: dict, num_frames: int, way: int, crop: int = 0, frame_hw: tuple = (0, 0)) -> int:
    """Bad clips of an episode (support and target), and its labels' consistency: each local
    label names one real class, the same in the support and the target clips."""
    bad = bad_rows(table, ep["support"], ep["real_support"], ep["support_labels"], num_frames, crop, frame_hw)
    bad += bad_rows(table, ep["target"], ep["real_target"], ep["target_labels"], num_frames, crop, frame_hw)
    names = {}
    for loc, real in list(zip(ep["support_labels"], ep["real_support"])) + list(zip(ep["target_labels"], ep["real_target"])):
        if not 0 <= int(loc) < way or names.setdefault(int(loc), int(real)) != int(real):
            bad += 1
    return bad


PACKED = ("in_proj_weight", "in_proj_bias")  # q | k | v of a ViT block's attention, in one tensor


def unpacked(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf, with a packed q | k | v in-projection as its three parts (``<name>.q`` ...): the
    key bias's gradient is nought but for rounding (softmax ignores a shift of the logits), so
    the exclusion rule has to see it apart from the query and value biases packed beside it."""
    out = {}
    for n, t in tensors.items():
        if n.endswith(PACKED):
            for part, piece in zip("qkv", t.chunk(3, dim=0)):
                out[f"{n}.{part}"] = piece
        else:
            out[n] = t
    return out


def _gap(program: Dict[str, float], ref: Dict[str, float], keep=None) -> tuple:
    """(worst leaf's |program norm - reference norm| / max(reference norm, median reference norm), that leaf)."""
    names = [n for n in ref if keep is None or n in keep]
    median = statistics.median(ref[n] for n in ref)
    worst = max(names, key=lambda n: abs(program[n] - ref[n]) / max(ref[n], median, 1e-30))
    return abs(program[worst] - ref[worst]) / max(ref[worst], median, 1e-30), worst


def _whole_gap(program: Dict[str, float], ref: Dict[str, float]) -> float:
    """|program's whole norm - reference's| / reference's, from the leaves' norms."""
    whole = lambda g: math.sqrt(sum(v * v for v in g.values()))  # noqa: E731
    return abs(whole(program) - whole(ref)) / max(whole(ref), 1e-30)


def descent_gap(program: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], along: Dict[str, torch.Tensor], keep) -> float:
    """|1 - <program, along> / <reference, along>| over the leaves in ``keep`` (host tensors)."""
    dot = lambda x: sum(float(torch.dot(x[n].flatten(), along[n].flatten())) for n in keep)  # noqa: E731
    r = dot(ref)
    return abs(1.0 - dot(program) / r) if r else float("inf")


def reference_train(inputs: Inputs, batches: List[dict], family, arch: dict, device, prec: Precision) -> dict:
    """The reference's first steps on the same batches, each step the configuration's
    ``family.reference_step``: each step's loss, the first gradient's norm by leaf, Adam's
    moments' norms by leaf after the last step (and the first moment on the host), the window's
    mean gradient's norm by leaf, and each leaf's change (its norm, and the tensor on the host)."""
    no_tf32()
    cfg = inputs.cfg
    w = {k: v.detach().to(device).float().clone() for k, v in inputs.weights.items()}
    w0 = {k: v.clone() for k, v in w.items()}
    params = {n: p for n, p in w.items() if "running_" not in n}
    t, s = cfg["TRAIN"], cfg["SOLVER"]
    wd = float(s.get("WEIGHT_DECAY", 0.0) or 0.0)
    bn_wd = float(cfg.get("BN", {}).get("WEIGHT_DECAY", 0.0) or 0.0)
    adam = Adam(params, {n: decay_of(n, wd, bn_wd) for n in params}, int(t.get("BATCH_SIZE_PER_TASK", 1)))
    chunks = int(cfg["TPU"].get("EPISODE_CHUNKS", 1))
    losses, first, mean = [], None, None
    for step, batch in enumerate(batches):
        loss, grads = family.reference_step(w, batch, inputs.bank, inputs.text_train, cfg, step, prec, arch, chunks)
        losses.append(loss)
        if first is None:
            first = norms(unpacked(grads))
        mean = {n: g.clone() for n, g in grads.items()} if mean is None else {n: mean[n] + grads[n] for n in grads}
        adam.step(grads, learning_rate(s, int(t.get("NUM_FOLDS", 1)), step))
        del grads
    change = unpacked({n: (w[n] - w0[n]).cpu() for n in params})
    return {"losses": losses, "first_grad": first, "moment": norms(unpacked(adam.m)), "moment2": norms(unpacked(adam.v)),
            "mean_grad": norms(unpacked({n: g / len(batches) for n, g in mean.items()})), "change": norms(change),
            "change_t": change, "moment_t": unpacked({n: m.cpu() for n, m in adam.m.items()})}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's norm, read in one copy to the host."""
    names = list(tensors)
    if not names:
        return {}
    return dict(zip(names, torch.stack([tensors[n].detach().float().norm() for n in names]).tolist()))


def train_readings(program: dict, ref: dict, bad: int) -> dict:
    """The numbers compared for a train cell; ``program`` holds the same keys as ``reference_train``'s
    but ``mean_grad`` and ``moment_t``."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(program["losses"], ref["losses"]))
    grad_gap, grad_leaf = _gap(program["first_grad"], ref["first_grad"])
    moment_gap, moment_leaf = _gap(program["moment"], ref["moment"])
    moment2_gap, moment2_leaf = _gap(program["moment2"], ref["moment2"])
    median = statistics.median(ref["mean_grad"].values())
    moved = {n for n, g in ref["mean_grad"].items() if g >= 1e-3 * median}
    change_gap, change_leaf = _gap(program["change"], ref["change"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "grad_norm_gap": _whole_gap(program["first_grad"], ref["first_grad"]),
            "moment_gap": moment_gap, "moment_norm_gap": _whole_gap(program["moment"], ref["moment"]),
            "moment2_gap": moment2_gap, "moment2_norm_gap": _whole_gap(program["moment2"], ref["moment2"]),
            "change_gap": change_gap, "descent_gap": descent_gap(program["change_t"], ref["change_t"], ref["moment_t"], sorted(moved)),
            "bad_rows": bad,
            "_worst": {"grad": grad_leaf, "moment": moment_leaf, "moment2": moment2_leaf, "change": change_leaf,
                       "left_out": sorted(set(ref["change"]) - moved)}}


def reference_test_logits(inputs: Inputs, episodes: List[dict], family, arch: dict, device, prec: Precision) -> List[np.ndarray]:
    """The reference's logits [Q, WAY] of each episode (bank rows and labels as host arrays), each
    the configuration's ``family.reference_logits``."""
    no_tf32()
    w = {k: v.detach().to(device).float() for k, v in inputs.weights.items()}
    out = []
    with torch.no_grad():
        for ep in episodes:
            rows = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in ep.items()}
            out.append(family.reference_logits(w, rows, inputs.bank, inputs.text_test, inputs.cfg, prec, arch).cpu().numpy())
    return out


def test_readings(program: List[np.ndarray], ref: List[np.ndarray], bad: int) -> dict:
    gaps = [float(np.abs(p - r).max() / max(np.abs(r).mean(), 1e-30)) for p, r in zip(program, ref)]
    return {"logit_gap": max(gaps), "bad_rows": bad}


def verdict(readings: dict, limits: dict) -> tuple:
    """(correct, the compared numbers as [value, limit]): every number at or under its limit."""
    compared = {k: [float(readings[k]), float(v)] for k, v in limits.items()}
    correct = all(np.isfinite(value) and value <= limit for value, limit in compared.values())
    return correct, compared
