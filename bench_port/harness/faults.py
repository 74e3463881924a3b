"""Faults planted under the timed path, to show that a run's check sees
them (`control.py`, `tests/`). Each takes one step's output and returns
what a faulty program would have returned. A verify step's output is the
mask on the host; a prove step's is a dict of wire tensors.
"""

from __future__ import annotations


def _is_mask(out) -> bool:
    return not isinstance(out, dict)


def unchanged(out):
    """The step returns its buffers as it got them: no verdict, no proof."""
    import torch

    if _is_mask(out):
        return torch.zeros_like(out)
    return {k: torch.zeros_like(v) for k, v in out.items()}


def half_batch(out):
    """Half of the batch left out: its answers copied from the other half."""
    import torch

    def halve(t):
        h = t.shape[-1] // 2
        return torch.cat([t[..., : t.shape[-1] - h], t[..., :h]], dim=-1)

    if _is_mask(out):
        return halve(out)
    return {k: halve(v) for k, v in out.items()}


def altered(out):
    """An answer altered where it is produced: the first lane's verdict
    flipped; in a proof, the first limb of the first final scalar of
    every lane moved by one."""
    if _is_mask(out):
        out = out.clone()
        out[0] = ~out[0]
        return out
    out = dict(out)
    key = "wnla_l"
    t = out[key].clone()
    t[0, 0] = (t[0, 0] + 1) % (1 << 16)
    out[key] = t
    return out


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
