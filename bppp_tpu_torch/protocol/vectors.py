"""Batched F_n vector math over limb tensors (twin of oracle/vectors.py).

Counterpart of `bppp_tpu/protocol/vectors.py`. A scalar is (16, *batch)
int64 limbs (see ops/field.py); a scalar *vector* is (16, L, *batch) with the length axis at position 1 so every
field op broadcasts over (L, *batch) lanes at once. Helpers pad shorter
operands with zeros, matching the reference's `vector_extend`.
"""

from __future__ import annotations

import torch

from ..ops import field as f


def sv_zeros(L: int, batch: tuple, device="cuda"):
    return torch.zeros((16, L) + tuple(batch), dtype=f.DTYPE, device=device)


def sv_pad(a, L: int):
    """Zero-pad the length axis (axis 1) to L."""
    if a.shape[1] == L:
        return a
    assert a.shape[1] < L
    pad = a.new_zeros((16, L - a.shape[1]) + tuple(a.shape[2:]))
    return torch.cat([a, pad], dim=1)


def _pad_pair(a, b):
    L = max(a.shape[1], b.shape[1])
    return sv_pad(a, L), sv_pad(b, L)


def sv_split(a):
    """Even/odd split along the length axis."""
    return a[:, 0::2], a[:, 1::2]


def sv_add(a, b):
    a, b = _pad_pair(a, b)
    return f.fn_add(a, b)


def sv_sub(a, b):
    a, b = _pad_pair(a, b)
    return f.fn_sub(a, b)


def sv_scale(a, s):
    """a * s with s a (16, *batch) scalar."""
    return f.fn_mul(a, s[:, None])


def sv_hadamard(a, b):
    a, b = _pad_pair(a, b)
    return f.fn_mul(a, b)


def sv_sum(a):
    """Mod-n sum over the length axis: (16, L, *batch) -> (16, *batch).
    Lazy limbwise sum (safe for L <= 2^15 since limbs < 2^16), one fold."""
    return f._fold_n(f._carry(a.sum(dim=1), 18))


def sv_inner(a, b):
    """<a, b> mod n."""
    a, b = _pad_pair(a, b)
    return sv_sum(f.fn_mul(a, b))


def sv_powers(x, L: int, start_at_one: bool = True):
    """[1, x, .., x^(L-1)] (start_at_one) or [x, x^2, .., x^L]; (16, L, *batch).
    Log-depth doubling build: e_{2k} = e_k || (x^k * e_k)."""
    one = torch.zeros_like(x)
    one[0] = 1
    e = one[:, None]  # [1]
    xp = x  # x^(current length)
    while e.shape[1] < L:
        e = torch.cat([e, f.fn_mul(e, xp[:, None])], dim=1)
        if e.shape[1] < L:
            xp = f.fn_mul(xp, xp)
    e = e[:, :L]
    if start_at_one:
        return e
    return f.fn_mul(e, x[:, None])


def sv_weight_inner(a, b, w, pw=None):
    """sum_i a_i b_i w^(i+1). pw: optional precomputed [w, w^2, ...]
    (16, >=L, *batch) to share across call sites."""
    a, b = _pad_pair(a, b)
    if pw is None:
        pw = sv_powers(w, a.shape[1], start_at_one=False)
    return sv_sum(f.fn_mul(f.fn_mul(a, b), pw[:, : a.shape[1]]))


def sv_tensor(a, b):
    """Kronecker concat of a*b_j for each j: out[:, j*La + i] = a_i * b_j."""
    La, Lb = a.shape[1], b.shape[1]
    prod = f.fn_mul(a[:, :, None], b[:, None, :])  # (16, La, Lb, *batch)
    prod = prod.movedim(2, 1)  # (16, Lb, La, *batch)
    return prod.reshape((16, La * Lb) + tuple(a.shape[2:]))


def sv_interleave(a, b):
    """out[:, 2t] = a_t, out[:, 2t+1] = b_t — inverse of sv_split."""
    assert a.shape == b.shape
    st = torch.stack([a, b], dim=2)  # (16, L, 2, *batch)
    return st.reshape((16, 2 * a.shape[1]) + tuple(a.shape[2:]))


def sv_neg(a):
    return f.fn_neg(a)


def sv_concat(parts):
    parts = list(parts)
    batch = parts[0].shape[2:]
    for p in parts:
        assert p.shape[2:] == batch
    return torch.cat(parts, dim=1)


def s_const(x: int, batch: tuple, device="cuda"):
    """Host int -> broadcast (16, *batch) limb constant."""
    assert 0 <= x < (1 << 256), "pass canonical residues"
    batch = tuple(batch)
    a = torch.from_numpy(f.int_to_limbs(x)).to(device)
    return a.reshape((16,) + (1,) * len(batch)).expand((16,) + batch)


def sv_const(xs: list[int], batch: tuple, device="cuda"):
    """Host int list -> (16, L, *batch) limb constant vector."""
    batch = tuple(batch)
    a = torch.from_numpy(f.ints_to_limbs(xs)).to(device)
    return a.reshape((16, len(xs)) + (1,) * len(batch)).expand((16, len(xs)) + batch)


def fn_inv_vec(a):
    """Batched modular inversion over the length axis via the Montgomery
    trick: ONE Fermat ladder for the whole vector + 3(L-1) muls, with the
    prefix/suffix products in log depth. a: (16, L, *batch), all entries
    nonzero. inv(a_i) = pre[i-1] * suf[i+1] * inv(prod of all)."""
    L = a.shape[1]
    if L == 1:
        return f.fn_inv(a[:, 0])[:, None]
    pre = _scan_mul(a)  # pre[i] = a_0 * ... * a_i
    total_inv = f.fn_inv(pre[:, L - 1])  # one ladder
    suf = _scan_mul(a.flip(1)).flip(1)  # suf[i] = a_i * ... * a_{L-1}
    one = torch.zeros_like(a[:, :1])
    one[0] = 1
    pre_shift = torch.cat([one, pre[:, :-1]], dim=1)
    suf_shift = torch.cat([suf[:, 1:], one], dim=1)
    return f.fn_mul(f.fn_mul(pre_shift, suf_shift), total_inv[:, None])


def _scan_mul(a):
    """Inclusive prefix product along axis 1, log-depth (Hillis-Steele)."""
    L = a.shape[1]
    out = a
    d = 1
    while d < L:
        prod = f.fn_mul(out[:, d:], out[:, :-d])
        out = torch.cat([out[:, :d], prod], dim=1)
        d *= 2
    return out
