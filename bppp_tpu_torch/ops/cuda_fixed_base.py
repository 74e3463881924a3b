"""Fixed-base windowed MSM: precomputed generator tables + CUDA kernel K3.

Counterpart of `bppp_tpu/ops/pallas_fixed_base.py`. For FIXED generators
the doubles and per-call table builds of a generic MSM disappear, and
W-bit windows cut the add count to ceil(256 / W) per generator:

  * setup, once per generator set (`build_tables`, one launch of the
    doubling chain K5b and one of `affine_rows`, which inverts each
    (window, generator) row of entries once): affine tables
    T[w][i][d] = [d * 2^(w*W)] G_i for every window w and digit d, as one
    int32 tensor of shape (NW, F, 2^W, 16) — per entry the 8 x-words then
    the 8 y-words, 32-bit little-endian, 64 bytes. Entry 0 is all-zero,
    the identity sentinel.
  * per call (`fixed_msm`): the kernel of `csrc/fixed_msm.cu` sums the
    F * NW terms of a lane: it extracts each W-bit digit from the scalar
    itself, loads the entry by index and folds it in with one incomplete
    mixed add.

A sum over a SUBSET of the generators reads the same table through a row
index: `Tables.take` / `subset` give a view that shares the words and
carries an int32 vector of table rows, which the kernel and the plain
version both read. Nothing is copied, so the prover's walks all read the
one table (26 MB at u64, inside the 50 MB L2 of an H100).

Replaces: `pallas_fixed_base._fixed_msm_kernel` (`fixed_msm_sum_flat`).
Bound on an H100: operations — F * NW mixed adds of 11 modular multiplies
per lane. The terms are independent, so a lane's walk is split into S
slices, one thread each, joined with complete adds (`slice_count` chooses
S from B and F so that a launch fills the card; `slice_bounds` says which
terms a slice takes).

The window width is a parameter of `build_tables`, recorded with the
table; the default 8 keeps the u64 table inside the L2 cache of an H100.

The kernel's adds are incomplete (a collision degrades to the identity,
unreachable for challenge scalars); the plain version below sums the same
table entries with complete adds. The two agree as POINTS (affine
coordinates, compressed bytes), not in (X, Y, Z).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from . import cuda_curve
from .cuda_curve import flat_i32

_VP = _build.VP

LAUNCHES = {"fixed_msm": 0}
PLAIN_CALLS = {"fixed_msm": 0}

DEFAULT_W = 8


class Tables(NamedTuple):
    """Window tables of fixed generators: the whole table, or a view of
    some of its rows (`rows`, int32 table indices on the table's device)."""

    words: torch.Tensor  # (NW, Ftab, 2^W, 16) int32
    w_bits: int
    subsets: dict  # {tuple of generator indices: row view}, filled by `subset`
    rows: torch.Tensor | None = None

    @property
    def n_windows(self) -> int:
        return self.words.shape[0]

    @property
    def n_points(self) -> int:
        """The generators a call walks: the rows of a view, else all."""
        return self.words.shape[1] if self.rows is None else self.rows.numel()

    def take(self, index) -> "Tables":
        """A view of some of the generators (axis 1), in `index` order: the
        same words and an index of their rows, nothing copied."""
        idx = torch.as_tensor(index, dtype=torch.int64)
        if self.rows is not None:
            idx = self.rows.cpu().to(torch.int64)[idx]
        if idx.ndim != 1 or not bool(((idx >= 0) & (idx < self.words.shape[1])).all()):
            raise ValueError(f"row index out of range of {self.words.shape[1]} generators")
        return Tables(self.words, self.w_bits, {}, idx.to(torch.int32).to(self.words.device))

    def subset(self, positions: tuple) -> "Tables":
        """`take(positions)`, made once per distinct tuple and kept with the
        tables: the prover's call sites each walk a static subset of the
        generators, and its row index is uploaded once."""
        positions = tuple(positions)
        if positions not in self.subsets:
            self.subsets[positions] = self.take(positions)
        return self.subsets[positions]


def n_windows(w_bits: int) -> int:
    return -(-256 // w_bits)


def build_tables(points, w_bits: int = DEFAULT_W) -> Tables:
    """points: PointJ coords (16, F) — unbatched fixed generators, none
    the identity. Built by doubling: D[t] = [2^t] G_i for every bit t, all
    NW * W - 1 doubles of every generator in ONE launch of the chain kernel
    (`cuda_curve.pt_double_chain`), then for each bit k of a window the
    entries [2^k, 2^(k+1)) = entries [0, 2^k) + D[w*W + k] as ONE batched
    complete add over all windows and generators, and the affine form by
    one inversion per (window, generator) row (`cuda_curve.affine_rows`,
    one launch). Affine values are unique, so the entries do not depend on
    the order of construction."""
    from .curve import PointJ, identity, pt_add

    if not 1 <= w_bits <= 16:
        raise ValueError(f"window width must be 1..16 bits, got {w_bits}")
    F = points.x.shape[1]
    NW = n_windows(w_bits)
    dev = points.x.device
    chain = cuda_curve.pt_double_chain(*points, NW * w_bits - 1)  # (16, NW*W - 1, F)
    dbl = [torch.cat([c[:, None], d], dim=1) for c, d in zip(points, chain)]  # D[t], (16, NW*W, F)
    # step[k]: coords (16, NW, F, 1) = [2^(w*W + k)] G_i for every window w
    step = [PointJ(*(d[:, k::w_bits, :, None] for d in dbl)) for k in range(w_bits)]
    ents = identity((NW, F, 1), device=dev)
    for k in range(w_bits):
        upper = pt_add(ents, step[k])
        ents = PointJ(*(torch.cat([a, b], dim=3) for a, b in zip(ents, upper)))
    NE = 1 << w_bits
    ax, ay = cuda_curve.affine_rows(*(c.reshape(16, NW * F, NE) for c in ents))

    def words(a):  # (16, NW * F, NE) limbs -> (NW, F, NE, 8) 32-bit words
        w = a[0::2] | (a[1::2] << 16)
        w = torch.where(w >= (1 << 31), w - (1 << 32), w)  # int32 bit pattern
        return w.to(torch.int32).reshape(8, NW, F, NE).permute(1, 2, 3, 0)

    return Tables(torch.cat([words(ax), words(ay)], dim=3).contiguous(), w_bits, {})


def table_affine(tab: Tables):
    """-> (x, y) int64 limb tensors (16, NW, F, 2^W): the affine entries."""
    w = tab.words.to(torch.int64) & 0xFFFFFFFF  # (NW, F, NE, 16)
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1)  # (NW, F, NE, 16, 2)
    x = limbs[..., :8, :].reshape(limbs.shape[:3] + (16,))
    y = limbs[..., 8:, :].reshape(limbs.shape[:3] + (16,))
    return x.permute(3, 0, 1, 2), y.permute(3, 0, 1, 2)


def _digits(scalars, w_bits: int = DEFAULT_W):
    """(16, F, B) limbs -> (NW, F, B) window digits (LSB first). Window w
    covers bits [W*w, W*(w+1)), which crosses 16-bit limb boundaries when
    W does not divide 16 — a zero guard limb covers the top window."""
    ext = torch.cat([scalars, torch.zeros_like(scalars[:1])], dim=0)
    rows = []
    for w in range(n_windows(w_bits)):
        lo = w_bits * w
        li, off = lo // 16, lo % 16
        v = ext[li] >> off
        if off + w_bits > 16:
            v = v | (ext[li + 1] << (16 - off))
        rows.append(v & ((1 << w_bits) - 1))
    return torch.stack(rows, dim=0)


# The slice plan. The walk's block holds 32 lanes x min(S, 4) slices, the
# join gives a lane JOIN_SLOTS slots (the kernels' WALK_SLICES, JOIN_SLOTS);
# S is a power of two.
JOIN_SLOTS = 8
MAX_SLICES = 32  # 64 was slower at (16, 49, 1024): a longer join, the same walk
MIN_TERMS = 8  # fewer terms per slice and the join outweighs the walk
# threads an H100 keeps resident: 132 SMs x 16 warps of 32 (<= 128 registers)
RESIDENT_THREADS = 132 * 16 * 32


def slice_count(B: int, F: int, n_win: int) -> int:
    """S, the threads ("slices") per lane of a B-lane walk over F
    generators of n_win windows: the largest power of two up to MAX_SLICES
    that keeps B * S within two waves of resident threads and at least
    MIN_TERMS terms per slice. 32 at B = 1024, 8 at B = 16384."""
    S = 1
    while (2 * S <= MAX_SLICES and B * 2 * S <= 2 * RESIDENT_THREADS
           and F * n_win // (2 * S) >= MIN_TERMS):
        S *= 2
    return S


def slice_bounds(n_terms: int, S: int):
    """[(lo, hi)] of the S slices: slice s walks the terms t = f * NW + w
    with lo <= t < hi, as the kernel computes them."""
    return [(s * n_terms // S, (s + 1) * n_terms // S) for s in range(S)]


def _check(tab: Tables, scalars):
    if scalars.ndim != 3 or scalars.shape[0] != 16 or scalars.shape[1] != tab.n_points:
        raise ValueError(
            f"scalars must be (16, {tab.n_points}, B), got {tuple(scalars.shape)}"
        )
    if tab.words.shape != (n_windows(tab.w_bits), tab.words.shape[1], 1 << tab.w_bits, 16):
        raise ValueError("table shape does not match its window width")
    if scalars.device != tab.words.device:
        raise ValueError("tables and scalars lie on different devices")


def fixed_msm_plain(tab: Tables, scalars):
    """The same sum in eager PyTorch: digits by `_digits`, entries by
    gather (through the row index of a view), then ONE log-depth tree of
    complete adds over all (window, generator) terms of a lane."""
    PLAIN_CALLS["fixed_msm"] += 1
    _check(tab, scalars)
    NW, F, B = tab.n_windows, tab.n_points, scalars.shape[2]
    dig = _digits(scalars, tab.w_bits)  # (NW, F, B)
    tx, ty = table_affine(tab)  # (16, NW, Ftab, NE)
    if tab.rows is not None:
        rows = tab.rows.to(torch.int64)
        tx, ty = tx[:, :, rows], ty[:, :, rows]
    idx = dig[None].expand(16, NW, F, B)
    qx = torch.gather(tx, 3, idx).reshape(16, NW * F, B)
    qy = torch.gather(ty, 3, idx).reshape(16, NW * F, B)
    is_id = (dig == 0).reshape(NW * F, B)
    one = torch.zeros_like(qx)
    one[0] = 1
    qz = torch.where(is_id, torch.zeros_like(qx), one)
    qy = torch.where(is_id, one, qy)
    return cuda_curve.tree_sum_plain(qx, qy, qz)


def fixed_msm(tab: Tables, scalars):
    """tab: tables of F generators (or a row view); scalars: (16, F, B)
    int64 canonical F_n limbs in TABLE (or view) order -> three (16, B)
    int64: the Jacobian sum sum_i [s_i] G_i per lane."""
    if not scalars.is_cuda:
        return fixed_msm_plain(tab, scalars)
    _check(tab, scalars)
    if tab.words.dtype != torch.int32 or not tab.words.is_contiguous():
        raise ValueError("table words must be a contiguous int32 tensor")
    if tab.rows is not None and (tab.rows.dtype != torch.int32 or not tab.rows.is_cuda):
        raise ValueError("a row index must be an int32 tensor on the card")
    sc = flat_i32(scalars, scalars.shape)
    F, B = scalars.shape[1], scalars.shape[2]
    S = slice_count(B, F, tab.n_windows)
    outs = [torch.empty((16, B), dtype=torch.int32, device=scalars.device) for _ in range(3)]
    part = torch.empty((S, 48, B), dtype=torch.int32, device=scalars.device) if S > 1 else None
    fn = _build.bind("fixed_msm", "bppp_fixed_msm", [_VP] * 7 + [ctypes.c_int] * 5 + [_VP])
    err = fn(tab.words.data_ptr(), None if tab.rows is None else tab.rows.data_ptr(),
             sc.data_ptr(), *(t.data_ptr() for t in outs),
             None if part is None else part.data_ptr(),
             F, tab.words.shape[1], B, tab.w_bits, S, _build.stream())
    LAUNCHES["fixed_msm"] += 1
    _build.check(err, "fixed_msm")
    return tuple(o.to(torch.int64) for o in outs)
