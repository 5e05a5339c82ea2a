"""Faults planted in the timed path, to show that the check finds them: each a function of the
run's program objects (``drive.TrainRun`` / ``drive.TestRun``) that breaks its step.

Train steps: a step that returns the state unchanged; half of the batch left out and the mean
taken over the rest; the step's loss 10 % off where it is produced; an optimizer window that
takes only its first micro-step's gradient (the others add nothing); an update of the opposite
sign (each gradient negated as the optimizer gets it); Adam's moments at betas (0.5, 0.99).
Eval steps: half of the batch left out (the other half's answers copied from it); an answer
altered where it is produced.  One chip only: no exchange between chips to leave out.
"""

from __future__ import annotations

import torch


def unchanged_state(run) -> None:
    """A train step that computes its gradient and metrics and leaves parameters and optimizer as they were."""
    from clip_fsar_torch.train.step import make_grad_fn

    grad_fn = make_grad_fn(run.model.head, run.cfg, run.model.text_train, run.model.text_test, run.bank.pixels)

    def step(state, batch, lr, gen):
        metrics = grad_fn(batch, gen)
        run.model.head.zero_grad(set_to_none=True)
        metrics["updated"] = torch.zeros((), dtype=torch.bool, device=metrics["loss"].device)
        return metrics

    run.step_fn = step


def half_batch_train(run) -> None:
    step = run.step_fn
    run.step_fn = lambda state, batch, lr, gen: step(state, batch.map(lambda x: x[: max(x.shape[0] // 2, 1)]), lr, gen)


def altered_loss(run) -> None:
    step = run.step_fn

    def altered(state, batch, lr, gen):
        out = step(state, batch, lr, gen)
        out["loss"] = out["loss"] * 1.1
        return out

    run.step_fn = altered


def _wrap_optimizer(run, before) -> None:
    """Call ``before(micro_step_index, optimizer)`` ahead of each optimizer micro-step."""
    opt = run.state.optimizer
    inner_step, calls = opt.step, [0]

    def step(lr, ok=None):
        before(calls[0] % opt.k, opt)
        calls[0] += 1
        return inner_step(lr, ok)

    opt.step = step


def dropped_micro_steps(run) -> None:
    def drop(i, opt):
        if i:
            for p in opt.params:
                if p.grad is not None:
                    p.grad.zero_()

    _wrap_optimizer(run, drop)


def reversed_update(run) -> None:
    def negate(i, opt):
        for p in opt.params:
            if p.grad is not None:
                p.grad.neg_()

    _wrap_optimizer(run, negate)


def wrong_moments(run) -> None:
    for group in run.state.optimizer.inner.param_groups:
        group["betas"] = (0.5, 0.99)


def half_batch_test(run) -> None:
    def wrap(step):
        def half(batch):
            e = batch.support_images.shape[0]
            out = step(batch.map(lambda x: x[: max(e // 2, 1)]))
            return {k: torch.cat([v] * (e // v.shape[0]) + [v[: e % v.shape[0]]]) for k, v in out.items()}
        return half
    run.step_wrap = wrap


def altered_answer(run) -> None:
    def wrap(step):
        def altered(batch):
            out = step(batch)
            logits = out["logits"].clone()
            logits[:, 0, 0] += 1.0
            return {**out, "logits": logits}
        return altered
    run.step_wrap = wrap


TRAIN = {"state_unchanged": unchanged_state, "half_batch": half_batch_train, "answer_altered": altered_loss,
         "dropped_micro_steps": dropped_micro_steps, "reversed_update": reversed_update, "wrong_moments": wrong_moments}
TEST = {"half_batch": half_batch_test, "answer_altered": altered_answer}
