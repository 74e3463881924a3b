"""The port's scale-out layer (`bppp_tpu_torch/parallel/`) in four gloo
ranks on the CPU, against the host oracle, the single-process port and the
JAX package.

One module fixture spawns the four ranks once per pytest run (its xdist
workers share the result through a file under pytest's base temporary
directory) and hands each rank's results to the tests:

  * sp: `prove_sharded` at |l| = |n| = 16 (two sharded rounds, a tail of
    4 / 4) over B = 2: every rank's proof bytes are the oracle's;
  * dp: the WNLA `verify_fast` of B = 4 lanes, one tampered, one lane per
    rank: the single-process mask; `shard_local_batch`'s lane offsets;
  * tp: `msm_sharded` at L = 16 over B = 3 lanes, lane 1's first two
    blocks equal (equal partials) and lane 2's third block under zero
    scalars (an identity partial): `curve.msm`'s point and the oracle's,
    with no call of the incomplete-add sum (K7's plain version);
  * `_psum_fn` against the JAX package's fold of the same summed limbs,
    `_shard_start_pow` against `pow`, and a mesh over the first two ranks.

While the ranks run, this process computes the single-process mask and
MSM they are held against. Every comparison is exact. `slow`: the sharded
prover and MSM against the JAX package's (XLA compiles them), the same
four ranks at the u64 range proof's WNLA sizes (|l| = 32, |n| = 16: two
sharded rounds, a tail of 8 / 4), and `dryrun_multichip(2)`.
"""

import fcntl
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from bppp_tpu_torch.models import WNLA_LABEL, wnla_fixture
from bppp_tpu_torch.ops import cuda_ladder
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.oracle import curve as oc
from bppp_tpu_torch.oracle.field import N
from bppp_tpu_torch.parallel import multihost
from bppp_tpu_torch.parallel.mesh import (
    Mesh, all_gather, all_reduce_sum, batch_slice, make_mesh, map_tensors, msm_sharded,
    shard_batch,
)
from bppp_tpu_torch.parallel.wnla_shard import (
    _psum_fn, _shard_start_pow, _sharded_rounds, prove_sharded,
)
from bppp_tpu_torch.protocol import convert as cv
from bppp_tpu_torch.protocol.wnla import WNLADevice, WNLAProofBytes
from bppp_tpu_torch.transcript.device import Transcript
from bppp_tpu_torch.utils.rng import SeededRng

# small tensors, several test processes side by side: intra-op threads only get in the way
torch.set_num_threads(1)

WORLD = 4
RANKS = list(range(WORLD))
SP_SIZES = (16, 16)  # |l|, |n| of the fixture's ranks
U64_SIZES = (32, 16)  # the u64 range proof's WNLA sizes (slow)
SEED = "torch parallel"
DP_TAMPERED = 2  # the dp lane whose final scalar is tampered
TP_L, TP_B = 16, 3
START_BLOCKS = (0, 1, 3, 8)
CPU = torch.device("cpu")


# -- the four ranks ------------------------------------------------------------------------


def _tile(tree, reps):
    """Every tensor of `tree` repeated `reps` times along its last (lane) axis."""
    return map_tensors(tree, lambda a: a.repeat((1,) * (a.ndim - 1) + (reps,)).contiguous())


def _tp_inputs():
    """TP_L seeded points and scalars over TP_B lanes; lane 1 repeats the
    first block's points and scalars as the second block, lane 2 has zero
    scalars in the third block. -> (PointJ (16, L, B), scalars, per-lane
    oracle points and scalars)."""
    rng = SeededRng(f"{SEED} tp")
    per = TP_L // WORLD
    lanes = []
    for b in range(TP_B):
        pts = [oc.GENERATOR.mul(rng.scalar()) for _ in range(TP_L)]
        ks = rng.scalars(TP_L)
        if b == 1:
            pts[per : 2 * per], ks[per : 2 * per] = pts[:per], ks[:per]
        if b == 2:
            ks[2 * per : 3 * per] = [0] * per
        lanes.append((pts, ks))
    coords = [tc.from_int_points(pts, device="cpu") for pts, _ in lanes]  # (16, L) each
    points = tc.PointJ(*(torch.stack([c[i] for c in coords], dim=-1) for i in range(3)))
    scalars = torch.from_numpy(np.stack([tf.ints_to_limbs(ks) for _, ks in lanes], axis=-1))
    return points, scalars, lanes


def _inputs(sizes):
    """Everything the ranks take, built once here: the sp instance at
    |l|, |n| = sizes and B = 2 with its oracle proofs, the same tiled to
    four lanes for dp (the oracle proofs as bytes, lane DP_TAMPERED's final
    scalar tampered), the tp points and scalars, and one canonical scalar
    column per rank for the psum."""
    fx = wnla_fixture(SEED, *sizes, 2, device="cpu", tables="never")
    d = fx.dev
    sp = dict(g=d.g, g_vec=d.g_vec, h_vec=d.h_vec, c=d.c, rho=d.rho, mu=d.mu, com=fx.com,
              l=fx.l, n=fx.n)
    pb = cv.wnla_proofs_to_bytes([fx.lanes[b % 2]["proof"] for b in RANKS], device="cpu")
    bad = pb.l.clone()
    bad[0, 0, DP_TAMPERED] = (bad[0, 0, DP_TAMPERED] + 1) % (1 << 16)
    dp = dict(_tile({k: sp[k] for k in ("g", "g_vec", "h_vec", "c", "rho", "mu", "com")}, 2),
              pb=pb._replace(l=bad))
    points, scalars, _ = _tp_inputs()
    prng = SeededRng(f"{SEED} psum")
    psum = [torch.from_numpy(tf.ints_to_limbs([N - 1 - prng.scalar() % 97 for _ in range(3)]))
            for _ in RANKS]
    return dict(sp=sp, dp=dp, tp=(points, scalars), psum=psum, mu=d.mu, lanes=fx.lanes)


def _rank_main(rank, rdzv, out_dir, inp):
    """One rank of the four: every part on its own mesh of the world, the
    results saved for the parent."""
    torch.set_num_threads(1)
    multihost.initialize(rdzv, WORLD, rank, device="cpu")
    try:
        res = {}
        # dp: this rank's lane, zero collectives; shard_local_batch's offset
        mesh = multihost.global_dp_mesh(device="cpu")
        dp = shard_batch(inp["dp"], mesh)
        wn = WNLADevice(*(dp[k] for k in ("g", "g_vec", "h_vec", "c", "rho", "mu")))
        lanes = dp["pb"].l.shape[-1]
        res["dp_mask"] = wn.verify_fast(
            dp["com"], Transcript(WNLA_LABEL, batch=(lanes,), device="cpu"), dp["pb"])
        res["dp_offset"] = multihost.shard_local_batch(dp["pb"], mesh)[1]
        # sp: the global instance, this rank's blocks
        sp = inp["sp"]
        proof = prove_sharded(
            make_mesh(axis="sp", device="cpu"), sp["g"], sp["g_vec"], sp["h_vec"], sp["c"],
            sp["rho"], sp["mu"], sp["com"], WNLA_LABEL, sp["l"], sp["n"])
        res["sp"] = cv.wnla_dev_to_bytes(proof)
        # tp: the global points, this rank's block; no call of the incomplete sum
        before = cuda_ladder.PLAIN_CALLS["tree_sum"]
        res["tp"] = tc.compress(msm_sharded(*inp["tp"], make_mesh(axis="tp", device="cpu")))
        res["tp_tree_sum_calls"] = cuda_ladder.PLAIN_CALLS["tree_sum"] - before
        # psum: the summed limbs and the folded sum
        x = inp["psum"][rank]
        res["psum_sum"] = all_reduce_sum(x, mesh)
        res["psum"] = _psum_fn(x, mesh)
        mu2 = tf.fn_mul(inp["mu"], inp["mu"])
        res["start_pow"] = {blk: _shard_start_pow(mu2, blk, rank) for blk in START_BLOCKS}
        # a mesh over the first two ranks
        sub = make_mesh(2, axis="dp", device="cpu")
        res["sub"] = None if sub is None else (
            sub.rank, sub.size, [int(a) for a in all_gather(torch.tensor([10 + rank]), sub)])
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, workdir, args, while_running=None):
    """Spawn `world` ranks of fn(rank, rendezvous, workdir, *args) with a
    file rendezvous in `workdir`; run `while_running()` here meanwhile.
    -> (its result, each rank's saved results)."""
    os.makedirs(workdir, exist_ok=True)
    rdzv = f"file://{os.path.join(workdir, 'rendezvous')}"
    ctx = torch.multiprocessing.spawn(fn, args=(rdzv, workdir, *args), nprocs=world, join=False)
    here = while_running() if while_running is not None else None
    while not ctx.join():
        pass
    return here, [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _single_process(inp):
    """What the ranks are held against, from this process: the dp mask of
    all four lanes, the tp MSM of the whole points axis."""
    dp = inp["dp"]
    wn = WNLADevice(*(dp[k] for k in ("g", "g_vec", "h_vec", "c", "rho", "mu")))
    mask = wn.verify_fast(dp["com"], Transcript(WNLA_LABEL, batch=(WORLD,), device="cpu"), dp["pb"])
    return dict(dp_mask=mask, tp=tc.compress(tc.msm(*inp["tp"])))


def _run_ranks(workdir, sizes=SP_SIZES):
    inp = _inputs(sizes)
    here, ranks = _spawn(_rank_main, WORLD, workdir, (inp,), lambda: _single_process(inp))
    return dict(here=here, ranks=ranks, lanes=[ln["proof"] for ln in inp["lanes"]],
                psum=inp["psum"], mu=inp["mu"])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four ranks' results, spawned once per pytest run: the first worker
    to get here runs them under a lock beside pytest's base temporary
    directory, and the others read what it saved."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # shared by the run's xdist workers
    saved = root / "torch_parallel_ranks.pt"
    with open(root / "torch_parallel_ranks.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not saved.exists():
            torch.save(_run_ranks(str(root / "torch_parallel_ranks")), saved)
    return torch.load(saved, weights_only=False)


# -- sp, dp, tp on every rank -----------------------------------------------------------


def _wire(pb, b):
    """Lane b of WNLAProofBytes as the oracle's bytes and integers."""
    return dict(r=pb.r[:, :, b].T.tolist(), x=pb.x[:, :, b].T.tolist(),
                l=cv.scalars_lane(pb.l, b), n=cv.scalars_lane(pb.n, b))


def _oracle_wire(proof):
    return dict(r=[list(p.to_bytes()) for p in proof.r], x=[list(p.to_bytes()) for p in proof.x],
                l=list(proof.l), n=list(proof.n))


@pytest.mark.parametrize("rank", RANKS)
def test_sp_proof_bytes_are_the_oracles_on_every_rank(run, rank):
    pb = run["ranks"][rank]["sp"]
    assert pb.x.shape[1] == 3 and pb.l.shape[1] == 2 and pb.n.shape[1] == 2  # 2 sharded + 1 tail round
    for b, proof in enumerate(run["lanes"]):
        assert _wire(pb, b) == _oracle_wire(proof), f"rank {rank}, lane {b}"


@pytest.mark.slow
def test_sp_at_the_u64_wnla_sizes_on_four_ranks(tmp_path):
    """The four ranks again at |l| = 32, |n| = 16: every rank's proof bytes
    are the oracle's, and the dp mask the single-process one."""
    run = _run_ranks(str(tmp_path), U64_SIZES)
    for rank, r in enumerate(run["ranks"]):
        pb = r["sp"]
        assert pb.x.shape[1] == 4 and pb.l.shape[1] == 2 and pb.n.shape[1] == 1  # 2 sharded + 2 tail
        for b, proof in enumerate(run["lanes"]):
            assert _wire(pb, b) == _oracle_wire(proof), f"rank {rank}, lane {b}"
        assert r["dp_mask"].tolist() == run["here"]["dp_mask"][rank : rank + 1].tolist()


@pytest.mark.parametrize("rank", RANKS)
def test_dp_masks_are_the_single_process_mask(run, rank):
    want = run["here"]["dp_mask"]
    assert want.tolist() == [b != DP_TAMPERED for b in RANKS]
    r = run["ranks"][rank]
    assert r["dp_mask"].tolist() == want[rank : rank + 1].tolist()
    assert r["dp_offset"] == rank


@pytest.mark.parametrize("rank", RANKS)
def test_tp_msm_equals_curve_msm_and_the_oracle_on_the_edge_lanes(run, rank):
    got = run["ranks"][rank]["tp"]
    assert torch.equal(got, run["here"]["tp"])
    for b, (pts, ks) in enumerate(_tp_inputs()[2]):
        acc = oc.IDENTITY
        for p, k in zip(pts, ks):
            acc = acc.add(p.mul(k))
        assert got[:, b].tolist() == list(acc.to_bytes()), f"lane {b}"
    assert run["ranks"][rank]["tp_tree_sum_calls"] == 0


@pytest.mark.parametrize("rank", RANKS)
def test_psum_fn_folds_like_the_jax_package(run, rank):
    import jax.numpy as jnp

    from bppp_tpu.ops import field as jf

    r = run["ranks"][rank]
    s = r["psum_sum"]
    assert torch.equal(s, sum(run["psum"]))  # every rank holds the same limb sum
    want = np.asarray(jf._fold_n(jf._carry(jnp.asarray(s.numpy().astype(np.uint32)), 18)))
    assert np.array_equal(r["psum"].numpy(), want.astype(np.int64))
    cols = [tf.limbs_to_ints(x) for x in run["psum"]]
    assert tf.limbs_to_ints(r["psum"]) == [sum(c[i] for c in cols) % N for i in range(3)]


@pytest.mark.parametrize("rank", RANKS)
def test_shard_start_pow_is_mu2_to_the_blocks_start(run, rank):
    mu = tf.limbs_to_ints(run["mu"])
    for blk, got in run["ranks"][rank]["start_pow"].items():
        assert tf.limbs_to_ints(got) == [pow(m * m % N, rank * blk, N) for m in mu], blk


def test_a_mesh_of_the_first_two_ranks(run):
    subs = [r["sub"] for r in run["ranks"]]
    assert subs == [(0, 2, [10, 11]), (1, 2, [10, 11]), None, None]


# -- without a process group ------------------------------------------------------------


def test_sharded_rounds_follow_the_jax_rule():
    # (|l|, |n|, ranks) -> rounds: the configurations of the tests and of chip_smoke.py
    for (lh, lg, nsh), k in {(32, 16, 4): 2, (16, 16, 4): 2, (64, 64, 4): 4, (64, 64, 1): 5,
                             (8, 8, 2): 2, (32, 32, 4): 3, (6, 3, 1): 0, (12, 4, 2): 1}.items():
        assert _sharded_rounds(lh, lg, nsh) == k, (lh, lg, nsh)


def test_batch_slice_and_shard_batch_cut_the_last_axis():
    mesh = Mesh(None, "dp", 2, 4, CPU)
    assert batch_slice(mesh, 8) == slice(4, 6)
    with pytest.raises(ValueError):
        batch_slice(mesh, 6)
    a = torch.arange(3 * 8).reshape(3, 8)
    tree = WNLAProofBytes(r=a, x=[a, (a, 5)], l={"k": a.T.contiguous().T}, n=None)
    cut = shard_batch(tree, mesh)
    assert cut.x[1][1] == 5 and cut.n is None
    for t in (cut.r, cut.x[0], cut.x[1][0], cut.l["k"]):
        assert t.is_contiguous() and torch.equal(t, a[:, 4:6])


def test_sizes_that_do_not_split_are_refused():
    mesh = Mesh(None, "tp", 0, 3, CPU)
    pts = tc.PointJ(*(torch.zeros(16, 8, 1, dtype=torch.int64) for _ in range(3)))
    with pytest.raises(ValueError):
        msm_sharded(pts, torch.zeros(16, 8, 1, dtype=torch.int64), mesh)
    with pytest.raises(ValueError):
        prove_sharded(mesh, tc.PointJ(*(a[:, 0] for a in pts)), pts, pts, None, None, None,
                      None, b"", None, None)


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        make_mesh(device="cpu")


# -- slow: against the JAX package, and the dry run --------------------------------------


def _sp_jax_rank(rank, rdzv, out_dir, args):
    torch.set_num_threads(1)
    multihost.initialize(rdzv, 2, rank, device="cpu")
    try:
        proof = prove_sharded(make_mesh(axis="sp", device="cpu"), *args)
        torch.save(cv.wnla_dev_to_bytes(proof), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_prove_sharded_equals_the_jax_prove_sharded(tmp_path):
    """The instance of the JAX package's `tests/test_wnla_sharded.py` (SZ = 8
    over 2 shards, its seed and label, built by its own oracle and convert
    functions as that test builds it), through the JAX `prove_sharded` on
    its CPU mesh (the program that test compiles, under its name in the JAX
    package's `aot` cache) and through the port's over two gloo ranks: the
    same bytes, and the oracle's."""
    import jax

    from bppp_tpu.oracle import curve as joc
    from bppp_tpu.oracle.field import fn_mul
    from bppp_tpu.oracle.merlin import Transcript as HostTranscript
    from bppp_tpu.oracle.wnla import WNLA
    from bppp_tpu.parallel.mesh import make_mesh as jax_mesh
    from bppp_tpu.parallel.wnla_shard import prove_sharded as jax_prove
    from bppp_tpu.protocol import convert as jcv
    from bppp_tpu.utils import aot
    from bppp_tpu.utils.rng import SeededRng as JaxSeededRng

    sz, nsh, B, label = 8, 2, 2, b"wnla sharded"
    rng = JaxSeededRng("wnla sharded")
    g = joc.GENERATOR.mul(rng.scalar())
    g_vec = [joc.GENERATOR.mul(rng.scalar()) for _ in range(sz)]
    h_vec = [joc.GENERATOR.mul(rng.scalar()) for _ in range(sz)]
    lanes = []
    for _ in range(B):
        c, rho, l, n = rng.scalars(sz), rng.scalar(), rng.scalars(sz), rng.scalars(sz)
        w = WNLA(g=g, g_vec=g_vec, h_vec=h_vec, c=c, rho=rho, mu=fn_mul(rho, rho))
        com = w.commit(l, n)
        lanes.append(dict(c=c, rho=rho, l=l, n=n, com=com,
                          proof=w.prove(com, HostTranscript(label), l, n)))
    dev = dict(
        g=jcv.point_batched(g, B), g_vec=jcv.points_batched(g_vec, B),
        h_vec=jcv.points_batched(h_vec, B), c=jcv.scalar_cols([ln["c"] for ln in lanes]),
        rho=jcv.f.ints_to_limbs([ln["rho"] for ln in lanes]),
        mu=jcv.f.ints_to_limbs([fn_mul(ln["rho"], ln["rho"]) for ln in lanes]),
        l=jcv.scalar_cols([ln["l"] for ln in lanes]), n=jcv.scalar_cols([ln["n"] for ln in lanes]),
        com=jcv.dc.from_int_points([ln["com"] for ln in lanes]),
    )
    to_t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64))
    pt = lambda p: tc.PointJ(*(to_t(a) for a in p))
    args = (pt(dev["g"]), pt(dev["g_vec"]), pt(dev["h_vec"]), to_t(dev["c"]), to_t(dev["rho"]),
            to_t(dev["mu"]), pt(dev["com"]), label, to_t(dev["l"]), to_t(dev["n"]))
    _, ours = _spawn(_sp_jax_rank, nsh, str(tmp_path), (args,))

    mesh = jax_mesh(nsh, axis="sp")

    def fn(dev):
        return jax_prove(mesh, "sp", dev["g"], dev["g_vec"], dev["h_vec"], dev["c"],
                         dev["rho"], dev["mu"], dev["com"], label, dev["l"], dev["n"])

    repl = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    jproof = aot.cached("test_wnla_sharded_prove", fn)(jax.device_put(dev, repl))
    for b, ln in enumerate(lanes):
        want = _oracle_wire(ln["proof"])
        assert _oracle_wire(jcv.wnla_dev_to_oracle(jproof, b)) == want
        for pb in ours:
            assert _wire(pb, b) == want


def _tp_jax_rank(rank, rdzv, out_dir, points, scalars):
    torch.set_num_threads(1)
    multihost.initialize(rdzv, WORLD, rank, device="cpu")
    try:
        got = msm_sharded(points, scalars, make_mesh(axis="tp", device="cpu"))
        torch.save(tc.compress(got), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.mark.slow
def test_msm_sharded_equals_the_jax_msm_sharded(tmp_path):
    """L = 8 points over 4 ranks (the port) and over the JAX package's
    4-device CPU mesh: the same points on every lane, edge lanes included."""
    import jax
    import jax.numpy as jnp

    from bppp_tpu.ops import curve as jc
    from bppp_tpu.parallel.mesh import make_mesh as jax_mesh
    from bppp_tpu.parallel.mesh import msm_sharded as jax_msm_sharded

    points, scalars, _ = _tp_inputs()
    points = tc.PointJ(*(a[:, :8].contiguous() for a in points))
    scalars = scalars[:, :8].contiguous()
    _, ours = _spawn(_tp_jax_rank, WORLD, str(tmp_path), (points, scalars))
    to_j = lambda a: jnp.asarray(a.numpy().astype(np.uint32))
    mesh = jax_mesh(WORLD, axis="tp")
    got = jax.jit(lambda p, s: jax_msm_sharded(p, s, mesh, axis="tp"))(
        jc.PointJ(*(to_j(a) for a in points)), to_j(scalars))
    want = np.asarray(jax.jit(jc.compress)(jc.PointJ(*(jnp.asarray(np.asarray(a)) for a in got))))
    for r in ours:
        assert np.array_equal(r.numpy(), want.astype(np.int64))


@pytest.mark.slow
def test_dryrun_multichip_on_two_cpu_ranks(capfd):
    from bppp_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    for mark in ("dp: step executed", "tp: sharded MSM done", "tp: cross-check done"):
        assert mark in out
