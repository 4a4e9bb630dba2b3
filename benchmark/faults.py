"""Faults planted under the timed path, to show that a run's check catches
them: each patches one function of the port for the life of a ``with``
block. The harness's runs never plant one; ``benchmark/control.py`` and
the tests do.

- ``altered_answer``: every answer comes out shifted by one along its
  answer axis (a retrieval score or a VQA logit belongs to the next
  caption or answer), where the scoring step produces it;
- ``half_batch``: the train step's loss, and so its gradients, are taken
  over the first half of the batch alone, the mean over the rest;
- ``unchanged_state``: the optimizer update returns without writing the
  parameters or the moments.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

FAULTS = ("altered_answer", "half_batch", "unchanged_state")


def _roll_last(t):
    import torch
    return torch.roll(t, 1, dims=-1)


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    from clipbert_tpu_torch.train import optim, steps
    saved = []

    def patch(mod, attr, new):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    if name == "altered_answer":
        prob_step, eval_step = steps.make_text_prob_step, steps.make_eval_step

        def make_text_prob_step(*a, **kw):
            fn = prob_step(*a, **kw)
            return lambda *x: _roll_last(fn(*x))

        def make_eval_step(*a, **kw):
            fn = eval_step(*a, **kw)

            def step(model, batch):
                out = dict(fn(model, batch))
                out["logits"] = _roll_last(out["logits"])
                return out
            return step

        patch(steps, "make_text_prob_step", make_text_prob_step)
        patch(steps, "make_eval_step", make_eval_step)
    elif name == "half_batch":
        loss = steps.compute_loss

        def compute_loss(model, cfg, ts, batch, *a, **kw):
            bv = batch["visual_inputs"].shape[0] // 2
            bt = bv * ts.group_size
            half = {k: v[:bt] if k != "visual_inputs" else v[:bv]
                    for k, v in batch.items()}
            return loss(model, cfg, ts, half, *a, **kw)

        patch(steps, "compute_loss", compute_loss)
    elif name == "unchanged_state":
        def adamw_update(params, grads, state, *a, **kw):
            import torch
            state.step += 1
            return torch.zeros(())

        patch(optim, "adamw_update", adamw_update)
    else:
        raise ValueError(f"unknown fault {name!r}; faults: {FAULTS}")
    try:
        yield
    finally:
        for mod, attr, orig in reversed(saved):
            setattr(mod, attr, orig)
