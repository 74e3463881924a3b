"""Traffic is a function of the seed, and spoils lanes where it says."""

import numpy as np
import pytest

from bench_port.harness import lanes, traffic

BIG = 2**40 + 12345


@pytest.mark.parametrize("seed", [7, BIG, 2**31 + 5])
def test_same_seed_same_traffic(seed):
    assert traffic.u64_values(seed, 8, [0, 2**64 - 1]) == traffic.u64_values(seed, 8, [0, 2**64 - 1])
    assert traffic.tamper_plan(seed, 4096, 1024) == traffic.tamper_plan(seed, 4096, 1024)
    assert traffic.sample_lanes(seed, 8192, 16, [0, 1]) == traffic.sample_lanes(seed, 8192, 16, [0, 1])
    a = traffic.poisson_arrivals(seed, 1000.0, 2.0)
    assert np.array_equal(a, traffic.poisson_arrivals(seed, 1000.0, 2.0))
    assert traffic.tamper_plan(seed, 4096, 1024) != traffic.tamper_plan(seed + 1, 4096, 1024)


def test_values_are_u64_with_the_fixed_ones_first():
    v = traffic.u64_values(BIG, 8, [0, 2**64 - 1])
    assert v[:2] == [0, 2**64 - 1] and len(v) == 8
    assert all(0 <= x < 2**64 for x in v)


def test_tampered_lanes_one_of_each_kind_per_block():
    plan = traffic.tamper_plan(BIG, 16384, 1024)
    assert len(plan) == 16 * 7
    for blk in range(16):
        in_blk = [(b, k) for b, k in plan if blk * 1024 <= b < (blk + 1) * 1024]
        assert sorted(k for _, k in in_blk) == sorted(traffic.TAMPER_KINDS)
        assert len({b for b, _ in in_blk}) == 7


def _arrays(B=4):
    rng = np.random.default_rng(0)
    lane = dict(com=bytes([2]) + bytes(32), c_l=bytes([3]) + bytes(range(32)), c_r=bytes([2]) + bytes(32),
                c_o=bytes([2]) + bytes(32), c_s=bytes([2]) + bytes(32), r=bytes([2]) + bytes(32),
                wnla_r=[bytes([2]) + bytes(32)] * 4, wnla_x=[bytes([3]) + bytes(32)] * 4,
                wnla_l=[tuple(int(v) for v in rng.integers(0, 1 << 16, 16))] * 2,
                wnla_n=[tuple(range(16))])
    return lanes.tile(lanes.to_arrays([lane, dict(lane, com=bytes([3]) + bytes(32))]), B)


@pytest.mark.parametrize("kind", traffic.TAMPER_KINDS)
def test_each_kind_changes_only_its_lane(kind):
    orig = _arrays()
    arrs = {k: v.copy() for k, v in orig.items()}
    traffic.apply_tamper(arrs, 2, kind, 2, orig)
    changed = {k for k in arrs if not np.array_equal(arrs[k], orig[k])}
    assert len(changed) == 1
    k = changed.pop()
    diff = np.argwhere(arrs[k] != orig[k])
    assert set(diff[:, -1].tolist()) == {2}


def test_lanes_round_trip():
    a = _arrays(3)
    back = lanes.to_arrays([lanes.lane_at(a, b) for b in range(3)])
    assert all(np.array_equal(a[k], back[k]) for k in a)


def test_device_scalars_are_below_n_and_seeded():
    import torch

    g1 = traffic.torch_generator(BIG, "cpu", "x")
    g2 = traffic.torch_generator(BIG, "cpu", "x")
    a = traffic.device_scalars(g1, (3, 64), "cpu")
    assert torch.equal(a, traffic.device_scalars(g2, (3, 64), "cpu"))
    assert int(a[15].max()) < 0xFFFF and int(a.min()) >= 0
