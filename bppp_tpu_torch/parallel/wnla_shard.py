"""Sequence-parallel WNLA: generator and scalar vectors cut across ranks.

Counterpart of `bppp_tpu/parallel/wnla_shard.py`. Every length-L vector
(g_vec, h_vec, c, l, n) is cut into contiguous blocks of even size, one
per rank: an even/odd split of the global index is then the even/odd
split of the local index, so the fold h' = h0 + y h1 stays on the rank.
Per round four collectives cross ranks:

  * the cross terms v_x, v_r: each rank's canonical partials, summed limb
    by limb (one `all_reduce`) and folded mod n once (`_psum_fn`);
  * the X and R partial MSMs: one all_gather of the ranks' Jacobian
    partials and a tree of complete adds (`mesh.combine_partials`);
  * the folded commitment, which the prover recomputes: its scalar part
    and its partial MSM, the same two again.

The transcript runs replicated: every rank absorbs the same bytes and
draws the same challenge, so nothing is broadcast. Once a further halving
would make a block odd, the small rest of the instance is gathered onto
every rank and finished by the single-card prover. The proof's bytes are
the single-card prover's: only where the work runs changes.
"""

from __future__ import annotations

import torch

from ..ops import curve as dc
from ..ops import field as f
from ..ops.curve import PointJ
from ..protocol import points as pv
from ..protocol import vectors as sv
from ..protocol.wnla import WNLADevice, WNLAProofDev, _msm_stack
from ..transcript.device import Transcript
from .mesh import Mesh, all_gather, all_reduce_sum
from .mesh import combine_partials as _combine_partials


def _partial_inner(c_blk, l_blk):
    """This rank's <c, l> over its block, canonical (16, *batch): a limb sum
    of canonical values stays in bounds, so ranks combine these by
    `_psum_fn`."""
    return sv.sv_inner(c_blk, l_blk)


def _weight_partial(n0, n1, mu2, block_start_pow):
    """sum_j n0_j n1_j mu2^(start + j + 1) over this rank's block, whose
    global indices begin at `start`: the local weighted sum times
    mu2^start."""
    return f.fn_mul(sv.sv_weight_inner(n0, n1, mu2), block_start_pow)


def _psum_fn(x, mesh: Mesh):
    """The sum mod n of every rank's canonical scalar (16, *batch): a limb
    sum over the ranks, then one fold. Each limb is below 2^16 and the
    carry takes a lazy sum of up to 2^15 terms."""
    if mesh.size > 2**15:
        raise ValueError(f"a limb sum over {mesh.size} ranks would leave the carry's bounds")
    return f._fold_n(f._carry(all_reduce_sum(x, mesh), 18))


def _shard_start_pow(mu_c, blk: int, rank: int):
    """mu_c^(rank * blk): the weight of the first index of this rank's
    block of blk. The JAX package picks it from all ranks' powers by a
    one-hot over its traced shard index; here the rank is a Python int, so
    the power is taken directly (exponent 0, on rank 0 or an empty block,
    is the constant 1: `pow_chain` takes no zero exponent)."""
    e = rank * blk
    if e == 0:
        return sv.s_const(1, tuple(mu_c.shape[1:]), device=mu_c.device)
    return f.fn_pow_const(mu_c, e)


def _sharded_rounds(lh: int, lg: int, nsh: int) -> int:
    """Rounds that keep every rank's block even: fold while |l| + |n| >= 6
    and both lengths divide by 2 * nsh."""
    k = 0
    while lh + lg >= 6 and lh % (2 * nsh) == 0 and lg % (2 * nsh) == 0:
        lh //= 2
        lg //= 2
        k += 1
    return k


def prove_sharded(
    mesh: Mesh,
    g: PointJ,
    g_vec: PointJ,
    h_vec: PointJ,
    c_vec,
    rho,
    mu,
    commitment: PointJ,
    label: bytes,
    l,
    n,
) -> WNLAProofDev:
    """Sharded WNLA prove. Every argument is GLOBAL and the same on every
    rank (coords and limbs (16, L, *batch), scalars and points
    (16, *batch)); this rank takes its block of each vector to its device.
    |h_vec| and |g_vec| must divide by the mesh size, and the rounds run
    sharded while they divide by twice that. Returns the single-card
    prover's proof, the same on every rank."""
    nsh, rank, dev = mesh.size, mesh.rank, mesh.device
    Lh, Lg = pv.pv_len(h_vec), pv.pv_len(g_vec)
    if Lh % nsh or Lg % nsh:
        raise ValueError(f"|h| = {Lh} and |g| = {Lg} must split over {nsh} ranks")
    batch = tuple(g.x.shape[1:])
    k_sharded = _sharded_rounds(Lh, Lg, nsh)

    def block(a, L):
        per = L // nsh
        return a[:, rank * per : (rank + 1) * per].to(dev)

    g_blk = PointJ(*(block(a, Lg) for a in g_vec))
    h_blk = PointJ(*(block(a, Lh) for a in h_vec))
    cv_ = block(sv.sv_pad(c_vec, Lh), Lh)
    l_c, n_c = block(l, Lh), block(n, Lg)
    g_pt = PointJ(*(a.to(dev) for a in g))
    com = PointJ(*(a.to(dev) for a in commitment))
    rho_c, mu_c = rho.to(dev), mu.to(dev)

    t = Transcript(label, batch=batch, device=dev)
    inv2 = sv.fn_inv_vec(torch.stack([rho_c, mu_c], dim=1))
    rho_inv, mu_inv = inv2[:, 0], inv2[:, 1]
    two = sv.s_const(2, batch, device=dev)
    xs, rs = [], []

    for k in range(k_sharded):
        # local pair-blocked splits (global parity == local parity)
        c0, c1 = sv.sv_split(cv_)
        l0, l1 = sv.sv_split(l_c)
        n0, n1 = sv.sv_split(n_c)
        g0, g1 = pv.pv_split(g_blk)
        h0, h1 = pv.pv_split(h_blk)
        mu2 = f.fn_mul(mu_c, mu_c)

        # local pair j is global pair rank * |n0| + j: weights mu2^(rank |n0|) on
        start_pow = _shard_start_pow(mu2, n0.shape[1], rank)
        vx_local = f.fn_add(
            f.fn_mul(_weight_partial(n0, n1, mu2, start_pow), f.fn_mul(rho_inv, two)),
            f.fn_add(_partial_inner(c0, l1), _partial_inner(c1, l0)),
        )
        vr_local = f.fn_add(_weight_partial(n1, n1, mu2, start_pow), _partial_inner(c1, l1))

        # X's and R's local partial MSMs without the g term, in one ladder,
        # combined over the ranks by one all_gather; the two cross terms by
        # one limb sum, and [v_x]g, [v_r]g by one more ladder
        xr_loc = _msm_stack([
            (
                pv.pv_concat([h0, h1, g0, g1]),
                sv.sv_concat([
                    sv.sv_pad(l1, pv.pv_len(h0)),
                    sv.sv_pad(l0, pv.pv_len(h1)),
                    sv.sv_pad(sv.sv_scale(n1, rho_c), pv.pv_len(g0)),
                    sv.sv_pad(sv.sv_scale(n0, rho_inv), pv.pv_len(g1)),
                ]),
            ),
            (
                pv.pv_concat([h1, g1]),
                sv.sv_concat([sv.sv_pad(l1, pv.pv_len(h1)), sv.sv_pad(n1, pv.pv_len(g1))]),
            ),
        ])  # (16, 2, *batch)
        vxr = _psum_fn(torch.stack([vx_local, vr_local], dim=1), mesh)
        xr = dc.pt_add(_combine_partials(xr_loc, mesh), dc.pt_scalar_mul(pv.single(g_pt), vxr))
        x_pt = PointJ(*(a[:, 0] for a in xr))
        r_pt = PointJ(*(a[:, 1] for a in xr))

        byts = dc.compress(pv.pv_concat([pv.single(com), pv.single(x_pt), pv.single(r_pt)]))
        t.append_message(b"wnla_com", byts[:, 0])
        t.append_message(b"wnla_x", byts[:, 1])
        t.append_message(b"wnla_r", byts[:, 2])
        t.append_u64(b"l.sz", Lh >> k)
        t.append_u64(b"n.sz", Lg >> k)
        y = t.challenge_scalar(b"wnla_challenge")

        # the fold stays on the rank (pair-blocked): one ladder for g0, g1, h1
        Lg0, Lg1, Lh1 = pv.pv_len(g0), pv.pv_len(g1), pv.pv_len(h1)
        scaled = dc.pt_scalar_mul(
            pv.pv_concat([g0, g1, h1]),
            sv.sv_concat([
                rho_c[:, None].expand((16, Lg0) + batch),
                y[:, None].expand((16, Lg1) + batch),
                y[:, None].expand((16, Lh1) + batch),
            ]),
        )
        g_blk = pv.pv_add(
            PointJ(*(a[:, :Lg0] for a in scaled)),
            PointJ(*(a[:, Lg0 : Lg0 + Lg1] for a in scaled)),
        )
        h_blk = pv.pv_add(h0, PointJ(*(a[:, Lg0 + Lg1 :] for a in scaled)))
        cv_ = sv.sv_add(c0, sv.sv_scale(c1, y))
        l_c = sv.sv_add(l0, sv.sv_scale(l1, y))
        n_c = sv.sv_add(sv.sv_scale(n0, rho_inv), sv.sv_scale(n1, y))
        rho_c, mu_c = mu_c, f.fn_mul(mu_c, mu_c)
        rho_inv, mu_inv = mu_inv, f.fn_mul(mu_inv, mu_inv)

        # the folded commitment, recomputed: v g + <h, l> + <g, n> over the ranks
        com_loc = pv.msm(
            pv.pv_concat([h_blk, g_blk]),
            sv.sv_concat([sv.sv_pad(l_c, pv.pv_len(h_blk)), sv.sv_pad(n_c, pv.pv_len(g_blk))]),
        )
        v_loc = f.fn_add(
            _partial_inner(cv_, l_c),
            _weight_partial(n_c, n_c, mu_c, _shard_start_pow(mu_c, n_c.shape[1], rank)),
        )
        com = dc.pt_add(_combine_partials(com_loc, mesh), dc.pt_scalar_mul(g_pt, _psum_fn(v_loc, mesh)))
        xs.append(x_pt)
        rs.append(r_pt)

    # the small rest onto every rank, blocks in rank order along the length axis
    def gather_sv(a):
        return torch.cat(all_gather(a, mesh), dim=1)

    def gather_pts(p):
        return PointJ(*torch.cat(all_gather(torch.stack(tuple(p)), mesh), dim=2))

    tail = WNLADevice(
        g_pt, gather_pts(g_blk), gather_pts(h_blk), gather_sv(cv_), rho_c, mu_c
    ).prove(com, t, gather_sv(l_c), gather_sv(n_c))
    # innermost-first: the tail's points first, the sharded rounds last
    return WNLAProofDev(
        r=pv.pv_concat([tail.r] + [pv.single(p) for p in reversed(rs)]),
        x=pv.pv_concat([tail.x] + [pv.single(p) for p in reversed(xs)]),
        l=tail.l,
        n=tail.n,
    )
