"""Faults planted underneath a run's timed path, to see ``correct`` come
out false (the CPU tests) and to read each fault's numbers at a cell's own
size (``calibrate.py`` on the card).

Training (around the program's ``get_train_step``):
``unchanged`` a step returns its state as it came; ``half_batch`` the
second half of a batch's rows replaced by the first half, so the mean is
taken over that half; ``altered`` the embedding's update dropped (an
answer changed where it is produced).

The fold (around the program's ``make_strategy``): ``unchanged`` the
round returns its base; ``half_batch`` every second site's result left
out, the mean taken over the rest; ``altered`` one coordinate of the new
model changed.
"""
from __future__ import annotations

import contextlib

import numpy as np

KINDS = ("unchanged", "half_batch", "altered")


def _train_step(step, kind: str):
    from repro_torch.train.steps import TrainState

    def faulty(state, batch):
        if kind == "half_batch":
            batch = {k: np.asarray(v) for k, v in batch.items()}
            h = batch["tokens"].shape[0] // 2
            batch = {k: np.concatenate([v[:h], v[:h]])
                     for k, v in batch.items()}
        new, metrics = step(state, batch)
        if kind == "unchanged":
            return state, metrics
        if kind == "altered":
            params = dict(new.params)
            params["embed"] = state.params["embed"]
            new = TrainState(params, new.opt_state, new.step)
        return new, metrics

    return faulty


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """Plant ``fault`` under traffic ``kind`` (``train_steps`` or
    ``sparse_fold``) for the duration of the block."""
    if kind == "train_steps":
        from repro_torch.train import steps

        real = steps.get_train_step

        def patched(*a, **kw):
            return _train_step(real(*a, **kw), fault)

        steps.get_train_step = patched
        try:
            yield
        finally:
            steps.get_train_step = real
        return
    from repro_torch.fl import strategy

    real_make = strategy.make_strategy

    def make(*a, **kw):
        st = real_make(*a, **kw)
        real_acc = st.fit_accumulator

        def fit_accumulator(rnd, current):
            acc = real_acc(rnd, current)
            add, fin, seen = acc.add, acc.finalize, []

            def add_some(node, res):
                seen.append(node)
                if fault != "half_batch" or len(seen) % 2:
                    add(node, res)

            def finalize(failures):
                out, metrics = fin(failures)
                if fault == "unchanged":
                    return current, metrics
                if fault == "altered":
                    out[0].reshape(-1)[0] += np.float32(1.0)
                return out, metrics

            acc.add, acc.finalize = add_some, finalize
            return acc

        st.fit_accumulator = fit_accumulator
        return st

    strategy.make_strategy = make
    try:
        yield
    finally:
        strategy.make_strategy = real_make
