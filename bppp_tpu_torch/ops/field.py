"""secp256k1 field arithmetic on limb tensors (PyTorch).

Counterpart of `bppp_tpu/ops/field.py`. A field element is an int64
tensor of shape (16, *batch): 16 little-endian limbs of 16 bits,
limb-major, batch axis last. That is the interchange layout shared with
the JAX package, so arrays cross between the two unchanged (the JAX side
stores the same limbs as uint32).

Why int64: on the CPU `torch.uint32` lacks add/shift/where, and int32
products of two 16-bit limbs wrap negative. In int64 every partial
product and every lazy column sum is exact; the CUDA kernels narrow to
32-bit storage at their edge and are free inside.

Reduction is fold-based, values stay canonical (no Montgomery domain):
  * F_p: p = 2^256 - 2^32 - 977, so 2^256 = 2^32 + 977 (mod p);
         two folds + one conditional subtract.
  * F_n: 2^256 = C (mod n) with C = 2^256 - n (129 bits);
         three folds + one conditional subtract.

Everything a public function returns is fully reduced with limbs < 2^16,
so equality with the JAX package is limb for limb. All public functions
broadcast over trailing batch shapes; axis 0 is the limb axis.

`fp_inv`, `fp_sqrt` and `fn_inv` are one exponentiation each, run as a
step list (`pow_chain`: an addition chain for the three exponents, a
sliding window for any other): on a CUDA tensor the whole list is one
kernel launch (`ops/cuda_msm.pow_const`), on a CPU tensor the plain
`_pow_const` runs the same list.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..oracle.field import N as N_INT
from ..oracle.field import P as P_INT

NLIMBS = 16
LIMB_BITS = 16
LIMB_MASK = 0xFFFF
DTYPE = torch.int64

# 2^256 mod n — the scalar-field fold constant (129 bits -> 9 limbs).
C_N_INT = (1 << 256) - N_INT


# -- host converters -------------------------------------------------------


def int_to_limbs(x: int, nlimbs: int = NLIMBS) -> np.ndarray:
    """Host: python int -> (nlimbs, 1) int64 limb column (broadcastable)."""
    out = np.zeros((nlimbs, 1), dtype=np.int64)
    for i in range(nlimbs):
        out[i, 0] = (x >> (LIMB_BITS * i)) & LIMB_MASK
    return out


def limbs_to_int(a) -> int:
    """Host: (nlimbs,) or (nlimbs, 1) limb array -> python int."""
    a = _np(a)
    a = a.reshape(a.shape[0], -1)
    assert a.shape[1] == 1, "limbs_to_int expects a single element"
    return sum(int(a[i, 0]) << (LIMB_BITS * i) for i in range(a.shape[0]))


def ints_to_limbs(xs, nlimbs: int = NLIMBS) -> np.ndarray:
    """Host: list of ints -> (nlimbs, B) int64."""
    return np.concatenate([int_to_limbs(x, nlimbs) for x in xs], axis=1)


def limbs_to_ints(a) -> list[int]:
    a = _np(a)
    return [
        sum(int(a[i, j]) << (LIMB_BITS * i) for i in range(a.shape[0]))
        for j in range(a.shape[1])
    ]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _int_limbs(x: int, n: int) -> list[int]:
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)]


P_ROWS_17 = tuple(_int_limbs(P_INT, 17))
N_ROWS_17 = tuple(_int_limbs(N_INT, 17))
N_LIMBS = int_to_limbs(N_INT)  # kept for transcript challenge reduction
C_N_ROWS_9 = tuple(_int_limbs(C_N_INT, 9))


_CONST_CACHE: dict = {}


def _const(c, like: torch.Tensor) -> torch.Tensor:
    """Host limb constant (L,), (L, 1) or list -> (L, 1, 1, ...) tensor on
    `like`'s device, broadcastable against `like` (cached per value)."""
    vals = c if isinstance(c, tuple) else tuple(int(x) for x in np.asarray(c).reshape(-1))
    key = (vals, like.device, like.ndim)
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.tensor(vals, dtype=DTYPE, device=like.device)
        t = t.reshape((len(vals),) + (1,) * (like.ndim - 1))
        _CONST_CACHE[key] = t
    return t


# -- array-level internals ---------------------------------------------------


def _zeros_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    return a.new_zeros((n,) + tuple(a.shape[1:]))


def _place(a: torch.Tensor, d: int, total: int) -> torch.Tensor:
    """Place a's limbs at offset d in a length-`total` limb axis; limbs
    that would fall past the end are dropped."""
    take = min(a.shape[0], total - d)
    parts = []
    if d:
        parts.append(_zeros_rows(a, d))
    parts.append(a[:take])
    if total - d - take:
        parts.append(_zeros_rows(a, total - d - take))
    return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]


def _shift_up(a: torch.Tensor, d: int) -> torch.Tensor:
    """Shift limbs toward higher indices by d (zeros shift in)."""
    return _place(a, d, a.shape[0])


_WEIGHTS = {n: tuple(1 << i for i in range(n)) for n in range(1, 40)}
_SHIFTS = {n: tuple(range(n)) for n in range(1, 40)}
_MBAR: dict = {}


def _carry_arr(v: torch.Tensor, out_len: int) -> torch.Tensor:
    """Lazy (L, *batch) limbs (0 <= entries < 2^31) -> out_len normalized
    limbs; overflow past the window drops. One local split pass leaves a
    per-limb carry-out g in {0, 1} and a propagate flag p (limb == 0xFFFF;
    the two exclude each other). The ripple is then ONE integer addition
    per lane: with G and P the bit masks of g and p over the limb axis,
    T = P + (G << 1) lets each generated carry run through the propagating
    limbs above it, and bit j of T ^ P is the carry into limb j."""
    L = v.shape[0]
    if L > out_len:
        raise ValueError("lazy input longer than carry target")
    if L < out_len:
        v = _place(v, 0, out_len)
    s = (v & LIMB_MASK) + _shift_up(v >> LIMB_BITS, 1)
    r = s & LIMB_MASK
    weights = _const(_WEIGHTS[out_len], v)
    G = ((s >> LIMB_BITS) * weights).sum(dim=0)
    P = ((r == LIMB_MASK) * weights).sum(dim=0)
    cin = (P + (G << 1)) ^ P
    shifts = _const(_SHIFTS[out_len], v)
    return (r + ((cin.unsqueeze(0) >> shifts) & 1)) & LIMB_MASK


def _cond_sub_arr(v: torch.Tensor, m_limbs) -> torch.Tensor:
    """If v >= m, v - m, else v; v (L, *batch) normalized. Two's-complement
    add of ~m + 1: the carry out of the window is the (v >= m) predicate."""
    L = v.shape[0]
    assert len(m_limbs) == L
    key = tuple(m_limbs)
    mbar = _MBAR.get(key)
    if mbar is None:
        mbar = _MBAR[key] = (LIMB_MASK - key[0] + 1,) + tuple(LIMB_MASK - x for x in key[1:])
    s = v + _const(mbar, v)
    full = _carry_arr(s, L + 1)
    return torch.where(full[L] == 1, full[:L], v)


def _shear_colsum(pp: torch.Tensor) -> torch.Tensor:
    """pp: (R, C, *batch) -> (R+C-1, *batch) anti-diagonal column sums
    out[k] = sum_i pp[i, k-i], via pad-flatten-reshape."""
    R, C = pp.shape[0], pp.shape[1]
    batch = tuple(pp.shape[2:])
    W = C + R
    padded = torch.cat([pp, pp.new_zeros((R, R) + batch)], dim=1)
    flat = padded.reshape((R * W,) + batch)
    sheared = flat[: R * W - R].reshape((R, W - 1) + batch)
    return sheared.sum(dim=0)


def _mul_wide_arr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(La, *b) x (Lb, *b) canonical -> (La+Lb, *b) LAZY columns (< 2^21):
    lo/hi halves of the exact 16x16 partial products, column-summed."""
    La, Lb = a.shape[0], b.shape[0]
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = a.expand((La,) + batch)
    b = b.expand((Lb,) + batch)
    pp = a.unsqueeze(1) * b.unsqueeze(0)  # (La, Lb, *batch)
    lo = _shear_colsum(pp & LIMB_MASK)
    hi = _shear_colsum(pp >> LIMB_BITS)
    return _place(lo, 0, La + Lb) + _place(hi, 1, La + Lb)


def _fold_p_arr(wide_lazy: torch.Tensor) -> torch.Tensor:
    """LAZY (32, *batch) columns (< 2^21) -> canonical 16 limbs mod p.
    x = L + H*(2^32 + 977), twice, then one conditional subtract."""
    L, H = wide_lazy[:16], wide_lazy[16:]
    t = _place(L, 0, 19) + _place(H * 977, 0, 19) + _place(H, 2, 19)
    t = _carry_arr(t, 19)
    L2, H2 = t[:16], t[16:19]
    t2 = _place(L2, 0, 17) + _place(H2 * 977, 0, 17) + _place(H2, 2, 17)
    t2 = _carry_arr(t2, 17)
    return _cond_sub_arr(t2, P_ROWS_17)[:16]


def _fold_n_arr(wide_lazy: torch.Tensor) -> torch.Tensor:
    """LAZY (<=32, *batch) columns -> canonical mod n. Normalizes first
    (the represented value must fit the column count, true for all call
    sites), then folds by C = 2^256 - n."""
    t = _carry_arr(wide_lazy, wide_lazy.shape[0])
    c9 = None
    while t.shape[0] > 17:
        if c9 is None:
            c9 = _const(C_N_ROWS_9, t)
        Lo, Hi = t[:16], t[16:]
        prod = _mul_wide_arr(Hi, c9)
        prod = _carry_arr(prod, prod.shape[0])
        m = max(16, prod.shape[0])
        nxt = 25 if t.shape[0] > 25 else (18 if t.shape[0] > 18 else 17)
        t = _carry_arr(_place(Lo, 0, m) + _place(prod, 0, m), nxt)
    if t.shape[0] < 17:
        t = _carry_arr(t, 17)
    return _cond_sub_arr(t, N_ROWS_17)[:16]


def _bcast2(a, b):
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    return a.expand((16,) + batch), b.expand((16,) + batch)


def _mod_add_arr(a, b, m17):
    a, b = _bcast2(a, b)
    return _cond_sub_arr(_carry_arr(a + b, 17), m17)[:16]


def _mod_sub_arr(a, b, m17):
    """(a + m - b) mod m over a 17-limb window (complement of b): the
    value is a + m - b + 2^272, and 2^272 drops out of the window."""
    a, b = _bcast2(a, b)
    c = (m17[0] + 1,) + tuple(m17[1:])
    low = a + (LIMB_MASK - b)
    top = a.new_full((1,) + tuple(a.shape[1:]), LIMB_MASK)
    s = torch.cat([low, top], dim=0) + _const(c, a)
    return _cond_sub_arr(_carry_arr(s, 17), m17)[:16]


# -- public F_p ops ----------------------------------------------------------


def fp_add(a, b):
    return _mod_add_arr(a, b, P_ROWS_17)


def fp_sub(a, b):
    return _mod_sub_arr(a, b, P_ROWS_17)


def fp_neg(a):
    return fp_sub(torch.zeros_like(a), a)


def fp_mul(a, b):
    return _fold_p_arr(_mul_wide_arr(a, b))


def fp_sqr(a):
    return fp_mul(a, a)


def fp_is_zero(a):
    return (a == 0).all(dim=0)


def fp_pow_const(x, e: int):
    """x^e mod p for a host-static exponent, 4-bit fixed windows."""
    from . import cuda_msm

    return cuda_msm.pow_const(x, e, "p")


def fp_inv(x):
    """Fermat: x^(p-2). fp_inv(0) == 0 (masked upstream for identity)."""
    return fp_pow_const(x, P_INT - 2)


def fp_sqrt(x):
    """x^((p+1)/4) — a square root when x is a QR (p = 3 mod 4); SOME
    defined value otherwise (callers check y^2 == x)."""
    return fp_pow_const(x, (P_INT + 1) // 4)


# -- public F_n ops ----------------------------------------------------------


def fn_add(a, b):
    return _mod_add_arr(a, b, N_ROWS_17)


def fn_sub(a, b):
    return _mod_sub_arr(a, b, N_ROWS_17)


def fn_neg(a):
    return fn_sub(torch.zeros_like(a), a)


def fn_mul(a, b):
    return _fold_n_arr(_mul_wide_arr(a, b))


def fn_is_zero(a):
    return (a == 0).all(dim=0)


def fn_pow_const(x, e: int):
    from . import cuda_msm

    return cuda_msm.pow_const(x, e, "n")


def fn_inv(x):
    return fn_pow_const(x, N_INT - 2)


def fn_sum(vals):
    """Mod-n sum over axis 0 of a (L, 16, *batch) stack of canonical
    elements — lazy limb sum (safe for L <= 2^15) then one fold."""
    return _fold_n_arr(_carry_arr(vals.sum(dim=0), 18))


# -- array-level lazy helpers (used by the vector layers) ---------------------


def _carry(v, out_len: int):
    return _carry_arr(v, out_len)


def _fold_n(wide):
    return _fold_n_arr(wide)


def _fold_p(wide):
    return _fold_p_arr(wide)


def _cond_sub(v, m_limbs: np.ndarray):
    """(L, *batch) normalized limbs; m_limbs host (L, 1). Public for the
    transcript's challenge reduction."""
    m = [int(m_limbs[i, 0]) for i in range(m_limbs.shape[0])]
    return _cond_sub_arr(v, m)


# -- shared helpers ------------------------------------------------------------


class PowChain(NamedTuple):
    """x^e as a step list over numbered slots of field elements. Slot 0
    holds x; step (dst, src, nsqr, mul) sets slot dst to slot src squared
    nsqr times, times slot mul (mul == -1: no multiply); after the last
    step slot `result` holds x^e."""

    steps: tuple
    result: int
    slots: int
    squares: int
    multiplies: int


# what the exponentiation kernel takes (csrc/pow.cu)
POW_MAX_STEPS = 80
POW_MAX_SLOTS = 10


class _ChainBuilder:
    def __init__(self):
        self.steps = []
        self.slots = 1  # slot 0 holds x
        self.free = []

    def new(self) -> int:
        if self.free:
            return self.free.pop()
        self.slots += 1
        return self.slots - 1

    def step(self, dst: int, src: int, nsqr: int, mul: int = -1) -> int:
        self.steps.append((dst, src, nsqr, mul))
        return dst

    def chain(self, result: int) -> PowChain:
        return PowChain(tuple(self.steps), result, self.slots,
                        sum(s[2] for s in self.steps), sum(s[3] >= 0 for s in self.steps))


def _windows(e: int, w: int) -> list:
    """MSB-first sliding windows of e: [(v, lo)], v odd and below 2^w, lo
    the position of v's lowest bit."""
    out, i = [], e.bit_length() - 1
    while i >= 0:
        if not (e >> i) & 1:
            i -= 1
            continue
        lo = max(i - w + 1, 0)
        while not (e >> lo) & 1:
            lo += 1
        out.append(((e >> lo) & ((1 << (i - lo + 1)) - 1), lo))
        i = lo - 1
    return out


def _odd_powers(b: _ChainBuilder, top: int, table: dict):
    """Fill `table` (v -> slot of x^v; x^1 in slot 0) with every odd power
    up to `top`, each x^2 times the one before. -> the slot of x^2 (free
    for reuse once the table is built), or None if none was needed."""
    table.setdefault(1, 0)
    if all(v in table for v in range(1, top + 1, 2)):
        return None
    sq = b.step(b.new(), 0, 1)
    for v in range(3, top + 1, 2):
        if v not in table:
            table[v] = b.step(b.new(), table[v - 2], 0, sq)
    return sq


def _slide(b: _ChainBuilder, acc, e: int, nbits: int, table: dict, w: int, dst: int) -> int:
    """Steps that take slot acc = x^a (acc None: a = 0) to x^(a 2^nbits +
    e), e < 2^nbits, window by window, written to slot dst. -> the slot
    of the result (a table slot if e is one window at bit 0 and a = 0)."""
    pos = nbits
    for v, lo in _windows(e, w):
        acc = table[v] if acc is None else b.step(dst, acc, pos - lo, table[v])
        pos = lo
    if pos:
        acc = b.step(dst, acc, pos)
    return acc


def _window_chain(e: int, w: int) -> PowChain:
    """x^e by a sliding window of width w over all of e's bits."""
    b = _ChainBuilder()
    table = {}
    sq = _odd_powers(b, max(v for v, _ in _windows(e, w)), table)
    return b.chain(_slide(b, None, e, e.bit_length(), table, w, b.new() if sq is None else sq))


def _ones_blocks(b: _ChainBuilder) -> dict:
    """x2, x3 = x^(2^2 - 1), x^(2^3 - 1), the first blocks of every named
    chain below. -> {k: slot of x^(2^k - 1)}."""
    x2 = b.step(b.new(), 0, 1, 0)
    return {1: 0, 2: x2, 3: b.step(b.new(), x2, 1, 0)}


def _fp_chain(e: int) -> PowChain:
    """x^((p+1)/4) or x^(p-2): p's 223 leading ones as blocks
    x_k = x^(2^k - 1) (k = 2, 3, 6, 9, 11, 22, 44, 88, 176, 220, 223),
    then the low 33 bits as tails, libsecp256k1's chains (253 squares + 13
    multiplies for the square root, 255 + 15 for the inverse)."""
    b = _ChainBuilder()
    x = _ones_blocks(b)
    t = b.step(b.new(), x[3], 3, x[3])  # x6
    t = b.step(t, t, 3, x[3])  # x9
    t = b.step(t, t, 2, x[2])  # x11
    x22 = b.step(t, t, 11, t)
    x44 = b.step(b.new(), x22, 22, x22)
    t = b.step(b.new(), x44, 44, x44)  # x88
    t = b.step(t, t, 88, t)  # x176
    t = b.step(t, t, 44, x44)  # x220
    t = b.step(t, t, 3, x[3])  # x223
    t = b.step(t, t, 23, x22)
    tails = ((6, x[2]), (2, -1)) if e == (P_INT + 1) // 4 else ((5, 0), (3, x[2]), (2, 0))
    for nsqr, mul in tails:
        t = b.step(t, t, nsqr, mul)
    return b.chain(t)


def _fn_inv_chain() -> PowChain:
    """x^(n-2): n's 127 leading ones as blocks x_k (k = 2, 3, 6, 8, 14,
    28, 56, 112, 126, 127), then a sliding window of width 4 over the low
    129 bits, its odd powers x^3 = x2 and x^7 = x3 taken from the blocks
    (256 squares + 41 multiplies)."""
    b = _ChainBuilder()
    x = _ones_blocks(b)
    x6 = b.step(b.new(), x[3], 3, x[3])
    x8 = b.step(b.new(), x6, 2, x[2])
    x14 = b.step(x6, x8, 6, x6)
    t = b.step(x8, x14, 14, x14)  # x28
    t = b.step(t, t, 28, t)  # x56
    t = b.step(t, t, 56, t)  # x112
    t = b.step(t, t, 14, x14)  # x126
    t = b.step(t, t, 1, 0)  # x127
    b.free.append(x14)
    low = (N_INT - 2) & ((1 << 129) - 1)
    table = {3: x[2], 7: x[3]}
    _odd_powers(b, max(v for v, _ in _windows(low, 4)), table)
    return b.chain(_slide(b, t, low, 129, table, 4, t))


def chain_exponent(chain: PowChain) -> int:
    """The exponent a step list computes, in integer arithmetic; raises
    if a step reads a slot that no step wrote."""
    exps = {0: 1}
    for dst, src, nsqr, mul in chain.steps:
        exps[dst] = (exps[src] << nsqr) + (exps[mul] if mul >= 0 else 0)
    return exps[chain.result]


_CHAINS: dict = {}


def pow_chain(e: int) -> PowChain:
    """The step list of x^e, 0 < e < 2^256, built once per exponent: the
    named chains for p - 2, (p+1)/4 and n - 2, else a sliding window of
    width 4 (its 8 odd powers and x^2 fit the kernel's slots). Checked in
    integer arithmetic: a list that does not compute e raises."""
    ch = _CHAINS.get(e)
    if ch is not None:
        return ch
    if not 0 < e < (1 << 256):
        raise ValueError("exponent out of range")
    if e in (P_INT - 2, (P_INT + 1) // 4):
        ch = _fp_chain(e)
    elif e == N_INT - 2:
        ch = _fn_inv_chain()
    else:
        ch = _window_chain(e, 4)
    if chain_exponent(ch) != e:
        raise ValueError(f"the step list of exponent {e:#x} computes another exponent")
    if len(ch.steps) > POW_MAX_STEPS or ch.slots > POW_MAX_SLOTS:
        raise ValueError(f"the step list of exponent {e:#x} has {len(ch.steps)} steps over "
                         f"{ch.slots} slots: at most {POW_MAX_STEPS} over {POW_MAX_SLOTS}")
    _CHAINS[e] = ch
    return ch


def _pow_const(x, e: int, mul):
    """x^e for a host-static exponent: `pow_chain(e)`'s steps, each square
    a `mul(a, a)`."""
    ch = pow_chain(e)
    slots = [x] + [None] * (ch.slots - 1)
    for dst, src, nsqr, m in ch.steps:
        a = slots[src]
        for _ in range(nsqr):
            a = mul(a, a)
        slots[dst] = a if m < 0 else mul(a, slots[m])
    return slots[ch.result].clone() if ch.result == 0 else slots[ch.result]


def select(mask, a, b):
    """Limb-wise select: mask is a batch-shaped bool; a where mask else b."""
    return torch.where(mask, a, b)


def limbs_lt_const(a, m: int):
    """Canonical-range check: (16, *batch) limbs < python int m ->
    (*batch,) bool. Lexicographic from the most-significant limb (the
    limbs themselves must be normalized 16-bit values)."""
    m_limbs = _int_limbs(m, NLIMBS)
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    eq = torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
    for i in range(NLIMBS - 1, -1, -1):
        lt = lt | (eq & (a[i] < m_limbs[i]))
        eq = eq & (a[i] == m_limbs[i])
    return lt


# -- byte conversions (for transcript absorption) -------------------------------


def limbs_to_be_bytes(a):
    """(16, *batch) limbs -> (32, *batch) big-endian bytes."""
    rev = a.flip(0)
    out = torch.stack([(rev >> 8) & 0xFF, rev & 0xFF], dim=1)
    return out.reshape((32,) + tuple(a.shape[1:]))


def be_bytes_to_limbs(b):
    """(32, *batch) big-endian bytes -> (16, *batch) limbs."""
    pairs = b.reshape((16, 2) + tuple(b.shape[1:])).flip(0)
    return ((pairs[:, 0] << 8) | pairs[:, 1]).to(DTYPE)
