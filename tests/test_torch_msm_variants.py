"""The port's three small-MSM kernels behind the reference's switches:
`curve.small_msm_variant` reads BPPP_GLV / BPPP_WNAF on every call as
`bppp_tpu/ops/curve.py` does, `curve.msm` then takes K4 (`msm_small_wnaf`),
K8 (`msm_small_glv`) or K9 (`msm_small`), and on the CPU each runs its
plain version. Held against the JAX package: its host oracle's
sum k_i P_i (compressed bytes), and for K8's and K4's inputs its GLV
decomposition called op by op, un-jitted. Every comparison is exact
(tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bppp_tpu.ops import glv as jglv
from bppp_tpu.oracle import curve as jc
from bppp_tpu_torch.ops import cuda_msm
from bppp_tpu_torch.ops import curve as tc
from bppp_tpu_torch.ops import field as tf
from bppp_tpu_torch.ops import glv as tglv
from bppp_tpu_torch.oracle.field import N, P

# small tensors, several test processes side by side: intra-op threads only get in the way
torch.set_num_threads(1)

B = 4
SETTINGS = {  # the switch settings: their environment
    "default": {},
    "BPPP_WNAF=0": {"BPPP_WNAF": "0"},
    "BPPP_GLV=0": {"BPPP_GLV": "0"},
}
KERNELS = ("msm_small_wnaf", "msm_small_glv", "msm_small")


def T(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int64))


def points_and_scalars(L, seed):
    """L points and scalars per lane from a seed, so that every chunk of
    `msm` sees the edge cases: lane 0 has zero scalars, lane 1 identity
    points, lane 2 the scalar lambda (GLV halves k1 = 0, k2 = 1) on every
    point; lane 3 is generic but for n - 1 on its last point."""
    rng = np.random.default_rng(seed)

    def scalar():
        return int.from_bytes(rng.bytes(40), "big") % N

    def rescale(p):
        z = int.from_bytes(rng.bytes(32), "big") % P or 1
        return jc.Point(p.x * z * z % P, p.y * z * z * z % P, p.z * z % P)

    pts = [[rescale(jc.GENERATOR.mul(scalar())) for _ in range(B)] for _ in range(L)]
    ks = [[scalar() for _ in range(B)] for _ in range(L)]
    for i in range(L):
        ks[i][0] = 0
        pts[i][1] = jc.IDENTITY
        ks[i][2] = tglv.LAMBDA
    ks[L - 1][3] = N - 1
    want = []  # the JAX package's oracle
    for b in range(B):
        acc = jc.IDENTITY
        for i in range(L):
            acc = acc.add(pts[i][b].mul(ks[i][b]))
        want.append(acc.to_bytes())
    coords = [
        T(np.stack([tf.ints_to_limbs([getattr(p, c) for p in row]) for row in pts], axis=1))
        for c in "xyz"
    ]  # (16, L, B)
    sc = T(np.stack([tf.ints_to_limbs(row) for row in ks], axis=1))  # (16, L, B)
    return tc.PointJ(*coords), sc, want


def lane_bytes(b):
    return [bytes(b[:, j].tolist()) for j in range(b.shape[1])]


@pytest.mark.parametrize(
    "glv_env, wnaf_env, want",
    [
        (None, None, "msm_small_wnaf"),
        ("1", "1", "msm_small_wnaf"),
        (None, "0", "msm_small_glv"),
        ("yes", "0", "msm_small_glv"),
        ("0", None, "msm_small"),
        ("0", "0", "msm_small"),
        ("0", "1", "msm_small"),
        ("", "", "msm_small_wnaf"),
    ],
)
def test_small_msm_variant_follows_the_switches(monkeypatch, glv_env, wnaf_env, want):
    """Any value but "0" means on; BPPP_GLV=0 wins over BPPP_WNAF; read on
    every call, so one process can switch between the three."""
    for name, val in (("BPPP_GLV", glv_env), ("BPPP_WNAF", wnaf_env)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    assert tc.small_msm_variant() == want
    monkeypatch.delenv("BPPP_GLV", raising=False)
    monkeypatch.delenv("BPPP_WNAF", raising=False)
    assert tc.small_msm_variant() == "msm_small_wnaf"


GLV_EDGE = [0, 1, N - 1, N // 2, N // 2 + 1, tglv.LAMBDA, (1 << 128) - 1, 1 << 255]


@pytest.fixture(scope="module")
def decomposed():
    """Edge and random scalars as (16, D = 3, 4) limbs, and the JAX
    package's `glv.decompose` of them (called once: op by op it costs
    seconds of dispatch)."""
    rng = np.random.default_rng(77)
    ks = GLV_EDGE + [int.from_bytes(rng.bytes(40), "big") % N for _ in range(4)]
    k = tf.ints_to_limbs(ks).reshape(16, 3, 4)
    return ks, k, jglv.decompose(jnp.asarray(k.astype(np.uint32)))


def test_glv_halves_match_the_jax_layout(decomposed):
    """K8's inputs: magnitudes and negate masks interleaved j = 2i + half,
    as `bppp_tpu/ops/curve.py::_msm_small_call` lays out the JAX package's
    `glv.decompose` for `msm_small_glv_flat` — and they recompose k."""
    ks, k, (m1, n1, m2, n2) = decomposed
    D, Bk = k.shape[1:]
    mags, signs = tglv.glv_halves(T(k))
    assert mags.shape == (2 * D, 16, Bk) and signs.shape == (2 * D, Bk)
    assert mags.dtype == torch.int64 and signs.dtype == torch.int64
    jmags = jnp.moveaxis(jnp.stack([m1, m2], axis=2).reshape(16, 2 * D, Bk), 1, 0)
    jsigns = jnp.stack([n1, n2], axis=1).reshape(2 * D, Bk).astype(jnp.uint32)
    assert np.array_equal(mags.numpy(), np.asarray(jmags).astype(np.int64))
    assert np.array_equal(signs.numpy(), np.asarray(jsigns).astype(np.int64))
    vals = np.asarray(ks, dtype=object).reshape(D, Bk)
    for i in range(D):
        for b in range(Bk):
            h = [tf.limbs_to_ints(mags[2 * i + half, :, b : b + 1].numpy())[0] for half in (0, 1)]
            s = [-h[half] if signs[2 * i + half, b] else h[half] for half in (0, 1)]
            assert (s[0] + s[1] * tglv.LAMBDA - vals[i, b]) % N == 0
            assert h[0] < (1 << 132) and h[1] < (1 << 132)


def test_wnaf_planes_match_the_jax_layout(decomposed):
    """K4's input: the signed-digit planes of both halves, plane index
    w * 2D + j, as the JAX package builds them for `msm_small_wnaf_flat`."""
    _, k, (m1, n1, m2, n2) = decomposed
    D, Bk = k.shape[1:]
    got = tglv.wnaf_planes(T(k))
    want = jnp.stack([jglv.wnaf_digits(m1, n1), jglv.wnaf_digits(m2, n2)], axis=2)
    want = want.reshape(tglv.GLV_WINDOWS * 2 * D, Bk)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("kernel", ["msm_small", "msm_small_glv"])
def test_u4_wrappers_take_one_to_three_points(kernel):
    """K8 and K9 are built for D = 1..3 (16-entry tables); a fourth point,
    or scalars that do not match the points, raise before any work."""
    pts, sc, _ = points_and_scalars(4, 1)
    coords = [c.movedim(1, 0).contiguous() for c in pts]  # (4, 16, B)
    k = sc[:, :4]
    ins = [k.movedim(1, 0).contiguous()] if kernel == "msm_small" else list(tglv.glv_halves(k))
    fn = getattr(cuda_msm, kernel)
    with pytest.raises(ValueError, match="1..3 points"):
        fn(*coords, *ins)
    small = [c[:2] for c in coords]
    with pytest.raises(ValueError, match=r"must be \(\d+, 16, "):
        fn(*small, *ins)
    assert cuda_msm.DMAX_U4 == 3


@pytest.mark.parametrize(
    "setting, L",
    [("default", L) for L in (1, 2, 4, 5)] + [(s, L) for s in ("BPPP_WNAF=0", "BPPP_GLV=0")
                                              for L in (4, 5)],
)
def test_msm_under_each_switch(monkeypatch, setting, L):
    """`curve.msm` at L points under each setting: the JAX oracle's bytes
    on every lane — so the three settings agree with each other byte for
    byte — through the plain version of the setting's kernel only, called
    in chunks of at most DMAX (K4) or DMAX_U4 (K8, K9) points. K4 takes
    L = 1, 2, 4, 5 in one call each; for K8 and K9, L = 4 and 5 cross the
    chunk boundary (3 + 1 and 3 + 2 points), so the two cases run each
    one's plain version at D = 1, 2, 3 with an identity point, a zero
    scalar and the scalar lambda."""
    monkeypatch.delenv("BPPP_GLV", raising=False)
    monkeypatch.delenv("BPPP_WNAF", raising=False)
    for name, val in SETTINGS[setting].items():
        monkeypatch.setenv(name, val)
    kernel = tc.small_msm_variant()
    pts, sc, want = points_and_scalars(L, 100 + L)
    calls = []
    fn = getattr(cuda_msm, f"{kernel}_plain")
    monkeypatch.setattr(cuda_msm, f"{kernel}_plain",
                        lambda px, *a: calls.append(px.shape[0]) or fn(px, *a))
    before = dict(cuda_msm.PLAIN_CALLS)
    got = tc.compress(tc.msm(pts, sc))
    assert lane_bytes(got) == want
    dmax = cuda_msm.DMAX if kernel == "msm_small_wnaf" else cuda_msm.DMAX_U4
    assert calls == [min(dmax, L - lo) for lo in range(0, L, dmax)]
    ran = {k: cuda_msm.PLAIN_CALLS[k] - before[k] for k in KERNELS}
    assert ran == {k: len(calls) if k == kernel else 0 for k in ran}
