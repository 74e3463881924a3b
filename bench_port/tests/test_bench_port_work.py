"""The kernels' work counts give fixed numbers on known shapes."""

import types

import torch

from bench_port.harness import registry

work = registry.metric("_work")


def t(*shape):
    return torch.empty(shape, dtype=torch.int64, device="meta")


def test_counts_on_known_shapes():
    M, S = 128, 72
    add, mixed, dbl = 11 * M + 5 * S, 7 * M + 4 * S, 2 * M + 5 * S
    assert work.f1600(t(200, 1024)) == (24 * 130 * 2 * 1024, 400 * 1024)
    assert work.pow_const(t(16, 10), (1 << 255) + 7, "p") == (255 * S * 10, 64 * 10)
    want = ((49 * 32 - 1) * mixed * 1024, (49 * 32 + 96) * 1024 + 49 * 64)
    for w_bits in (4, 8, 12):  # the program's table width does not move the count
        assert work.fixed_msm(types.SimpleNamespace(w_bits=w_bits), t(16, 49, 1024)) == want
    assert work.pt_add(*[t(16, 8)] * 6) == (add * 8, 6 * 8 * 32 + 96 * 8)
    assert work.pt_add(*[t(16, 8)] * 3, *[t(16, 1)] * 3) == (add * 8, 3 * 8 * 32 + 3 * 32 + 96 * 8)
    assert work.pt_double_chain(t(16, 49), t(16, 49), t(16, 49), 255) == (255 * dbl * 49, 96 * 49 * 256)
    assert work.tree_sum(t(16, 17, 1024), t(16, 17, 1024), t(16, 17, 1024)) == (16 * add * 1024,
                                                                                 18 * 96 * 1024)
    sm = 127 * dbl + 2 * 22 * add
    assert work.scalar_mul(t(16, 4), t(16, 4), t(16, 4), t(16, 4)) == (sm * 4, 4 * (96 + 32 + 96))
    d5 = 127 * dbl + 5 * 2 * 22 * add
    assert work.msm_small_wnaf(t(5, 16, 1024), None, None, None) == (d5 * 1024, (5 * 128 + 96) * 1024)
    assert work.affine_rows(t(16, 3, 256), None, None) == (
        3 * (255 * S + 256 * (6 * M + S)), 3 * 256 * 160)


def test_bound_is_the_larger_side():
    assert work.bound_s(33.5e12, 0) == 1.0
    assert work.bound_s(0, 3.35e12) == 1.0
    assert work.bound_s(33.5e12, 3.35e12 * 2) == 2.0


def test_every_wrapper_has_a_count():
    for fns in work.WRAPPERS.values():
        for fn in fns:
            assert callable(getattr(work, fn))


def test_launch_log_counts_card_launches_and_restores_the_wrappers():
    import importlib

    from bench_port.harness import program

    mods = {m: importlib.import_module(f"bppp_tpu_torch.ops.{m}") for m in work.WRAPPERS}
    before = {(m, f): getattr(mods[m], f) for m, fs in work.WRAPPERS.items() for f in fs}
    log = []
    with program.launch_log(log):
        assert all(getattr(mods[m], f) is not before[(m, f)] for (m, f) in before)
    assert all(getattr(mods[m], f) is before[(m, f)] for (m, f) in before)

    card = types.SimpleNamespace(is_cuda=True, shape=(200, 64))
    wrapped = program._counting(lambda s: "ran", work.f1600, "f1600", log)
    assert wrapped(card) == "ran" and log == [("f1600",) + work.f1600(card)]
    assert wrapped(t(200, 64)) == "ran" and len(log) == 1  # not on a card: no launch
