"""Faults planted under a cell's timed path, for the tests that see
``correct`` come out false and for fault readings on the card
(``control.py --fault``).  Each takes the cell before its warm-up and
breaks the program's path in place."""

import torch


def swap_classes(cell):
    """An answer altered where it is produced: the two probabilities of
    every written pixel swapped."""
    run = cell.runner._mask_output

    def mask_output(*a, **k):
        out, keep = run(*a, **k)
        return out.flip(0), keep
    cell.runner._mask_output = mask_output


def half_batch_predict(cell):
    """Half of each forward's batch left out, the other half's answers
    given for it."""
    fwd = cell.runner._forward

    def forward(x, meta):
        h = max(x.shape[0] // 2, 1)
        out = fwd(x[:h], None if meta is None else meta[:h])
        return torch.cat([out, out])[:x.shape[0]]
    cell.runner._forward = forward


def unchanged_state(cell):
    """A step that returns its state unchanged."""
    cell.segpipe.state.optimizer.step = lambda *a, **k: None


def half_batch_train(cell):
    """Half of the batch left out, the mean taken over the rest."""
    step = cell.segpipe._train_step_pooled

    def half(state, data, labels, ech_idx, starts, gen, **k):
        h = ech_idx.shape[0] // 2
        return step(state, data, labels, ech_idx[:h], starts[:h], gen, **k)
    cell.segpipe._train_step_pooled = half


FAULTS = {f.__name__: f for f in (swap_classes, half_batch_predict,
                                  unchanged_state, half_batch_train)}
