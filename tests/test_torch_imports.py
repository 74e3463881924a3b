"""The port stands alone: no module of bppp_tpu_torch, nor chip_smoke.py,
imports jax or anything of bppp_tpu, and importing the package pulls in
neither."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "bppp_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "bppp_tpu_torch")):
        if "_build" in base.split(os.sep):
            continue
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_module_imports_no_jax_and_nothing_of_the_jax_package(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{os.path.relpath(path, ROOT)} imports {name}"


def test_every_port_module_is_walked():
    rel = {os.path.relpath(p, ROOT) for p in _sources()}
    for must in ("chip_smoke.py", "bppp_tpu_torch/ops/field.py", "bppp_tpu_torch/ops/_build.py",
                 "bppp_tpu_torch/protocol/u64.py", "bppp_tpu_torch/oracle/merlin.py",
                 "bppp_tpu_torch/native/__init__.py", "bppp_tpu_torch/entry.py",
                 "bppp_tpu_torch/ops/pippenger.py", "bppp_tpu_torch/protocol/convert.py",
                 "bppp_tpu_torch/models/__init__.py", "bppp_tpu_torch/parallel/mesh.py",
                 "bppp_tpu_torch/parallel/multihost.py", "bppp_tpu_torch/parallel/wnla_shard.py"):
        assert must in rel


def test_importing_the_port_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, pkgutil, importlib, bppp_tpu_torch\n"
        "for m in pkgutil.walk_packages(bppp_tpu_torch.__path__, 'bppp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'bppp_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_fails_without_a_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# -- what chip_smoke.py compares and reports -------------------------------------------


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("B", [5, 64, 70, 131, 203, 1024, 17 * 1024, 32 * 1024])
def test_chip_smoke_compares_lanes_from_both_ends_of_a_launch(B):
    """The lanes a slow plain version runs on reach the last lane, so the
    partial tail block of a ragged batch is compared too, and keep lanes
    0..4, where the checks put their special values."""
    cs = _chip_smoke()
    lanes = cs.plain_lanes(B, "cpu").tolist()
    assert len(lanes) == min(B, cs.PLAIN_B) and len(set(lanes)) == len(lanes)
    assert lanes[: min(B, 5)] == list(range(min(B, 5))) and lanes[-1] == B - 1
    assert all(0 <= i < B for i in lanes)
    if B > cs.PLAIN_B:
        assert (B - 1) // 64 == lanes[-1] // 64 and lanes[-32] == B - 32


@pytest.mark.parametrize("name", ["f1600", "pow_const", "fixed_msm", "msm_small_wnaf", "pt_add",
                                  "pt_double", "scalar_mul", "tree_sum", "msm_small_glv",
                                  "msm_small", "affine_rows"])
def test_chip_smoke_names_each_kernel_its_source_and_what_it_replaces(name):
    cs = _chip_smoke()
    source, replaces = cs.REPLACES[name]
    with open(os.path.join(ROOT, source)) as fh:
        text = fh.read()
    assert "__global__" in text and f"bppp_{name}" in text
    path, line = replaces.split(":")
    with open(os.path.join(ROOT, path)) as fh:
        lines = fh.readlines()
    assert "pl.pallas_call(" in lines[int(line) - 1], lines[int(line) - 1]
    assert name in cs.MAIN_ROW and any(name in ks for ks in cs.PATH_KERNELS.values())
    assert any(name in mod.LAUNCHES and name in mod.PLAIN_CALLS for mod in cs.COUNTERS)


def test_chip_smoke_holds_every_small_msm_point_count_against_the_plain_version():
    """K4 is compiled once per point count D; the paths reach D = 1, 2, 4
    and 5. The kernels phase runs all of 1..DMAX."""
    import inspect

    cs = _chip_smoke()
    src = inspect.getsource(cs.phase_kernels)
    assert "for D in range(1, cuda_msm.DMAX + 1)" in src
    assert "check_msm_small(gen, dev, BATCH, D)" in src


@pytest.mark.parametrize("kernel", ["msm_small_glv", "msm_small"])
def test_chip_smoke_holds_every_point_count_of_k8_and_k9(kernel):
    """K8 and K9 are compiled once per point count D = 1 ... DMAX_U4; the
    variant paths reach all three. The kernels phase has a row for each,
    and a ragged one; the kernel's paths are the variant paths of its
    switch, which name it in place of K4."""
    import inspect

    cs = _chip_smoke()
    src = inspect.getsource(cs.phase_kernels)
    assert "for D in range(1, cuda_msm.DMAX_U4 + 1)" in src
    assert "check_msm_small(gen, dev, BATCH, D, kernel)" in src
    assert f'check_msm_small(gen, dev, 70, 3, "{kernel}")' in src
    # the tail block of a split launch at an even slot count, and a batch
    # that fills the card under whichever launch the plan takes there
    assert f'check_msm_small(gen, dev, 77, 2, "{kernel}")' in src
    assert "check_msm_small(gen, dev, BIG_BATCH, cuda_msm.DMAX_U4, kernel)" in src
    assert cs.cuda_msm.DMAX_U4 == 3
    tag = next(t for t, env in cs.VARIANTS.items() if cs.variant_kernel(env) == kernel)
    for base in cs.BASE_PATHS:
        ks = cs.PATH_KERNELS[f"{base}_{tag}"]
        assert kernel in ks and "msm_small_wnaf" not in ks
        assert cs.PATH_BANNED[f"{base}_{tag}"] == ("msm_small_wnaf",)
    assert cs.COUNTED_ON[kernel] == f"verify_{tag}"
    assert cs.MAIN_ROW[kernel] == f"{kernel}[D=3]"


@pytest.mark.parametrize("part", ["dp", "tp", "sp"])
def test_chip_smoke_counts_each_parallel_part_as_a_path(part):
    """The parallel phase drives dp, tp and sp as paths of their own, counted
    on every rank and reported in the kernels line; tp and sp combine the
    ranks' partials with the complete add (K5a), and what a world of one
    rank need not launch is a kernel of the path."""
    import inspect

    cs = _chip_smoke()
    path = f"parallel_{part}"
    kernels = cs.PATH_KERNELS[path]
    assert set(cs.SHARDED_ONLY.get(path, ())) <= set(kernels)
    assert part == "dp" or "pt_add" in kernels
    assert "by_path.update(phase_parallel(dev, ctx, shapes))" in inspect.getsource(cs.main)


@pytest.mark.parametrize("sz", [16, 32, 64])
def test_chip_smoke_drives_wnla_at_the_reference_sizes(sz):
    """The wnla phase runs the standalone argument at the JAX package's
    sizes; each run must launch the fixed-base MSM, the ladder and the
    tree sum (commit walks 1 + 2 sz points)."""
    cs = _chip_smoke()
    assert sz in cs.WNLA_SIZES
    assert {"fixed_msm", "scalar_mul", "tree_sum"} <= set(cs.PATH_KERNELS[f"wnla{sz}"])


@pytest.mark.parametrize("sz", [16, 32, 64])
def test_chip_smoke_holds_k3_k6_k7_at_every_shape_the_paths_give_them(monkeypatch, sz):
    """The full run records what each launch of K3, K6 and K7 is given and
    the kernels phase adds a row for each: here the WNLA commitment's shapes
    at this size (K6 over (1 + 2 sz) x 1024 lanes, K7 over 1 + 2 sz points
    of 1024 lanes)
    and its table, recorded through stand-ins for the three wrappers."""
    import inspect
    import types

    import torch

    cs = _chip_smoke()
    calls = []
    for mod, name in ((cs.cuda_ladder, "scalar_mul"), (cs.cuda_ladder, "tree_sum"),
                      (cs.cuda_fixed_base, "fixed_msm")):
        monkeypatch.setattr(mod, name, lambda *a, name=name: calls.append(name))
    stand_ins = (cs.cuda_ladder.scalar_mul, cs.cuda_ladder.tree_sum, cs.cuda_fixed_base.fixed_msm)
    L = 1 + 2 * sz
    tab = types.SimpleNamespace(n_points=L)
    known = types.SimpleNamespace(n_points=49)
    log = cs.new_shape_log()
    with cs.recording_shapes(log, f"wnla{sz}"):
        pts = torch.zeros((16, L, 1), dtype=torch.int64).expand(16, L, cs.BATCH)
        cs.cuda_ladder.scalar_mul(pts, pts, pts, pts[:, :1])
        cs.cuda_ladder.tree_sum(pts, pts, pts)
        cs.cuda_fixed_base.fixed_msm(tab, None)
        cs.cuda_fixed_base.fixed_msm(known, None)
    assert calls == ["scalar_mul", "tree_sum", "fixed_msm", "fixed_msm"]
    assert (cs.cuda_ladder.scalar_mul, cs.cuda_ladder.tree_sum,
            cs.cuda_fixed_base.fixed_msm) == stand_ins
    k6, k7, k3 = cs.shape_plan(log, (known,))
    assert L * cs.BATCH in k6 and set(cs.SCALAR_MUL_LANES) <= set(k6)
    assert (L, cs.BATCH) in k7 and set(cs.TREE_SUM_SHAPES) <= set(k7)
    assert k3 == [(tab, f"wnla{sz}")]
    src = inspect.getsource(cs.main)
    for phase in ("verify", "mirror", "prove", "variants", "wnla"):
        assert f'recording_shapes(shapes, "{phase}")' in src
    assert "counted, shapes)" in src
    assert "shape_plan(" in inspect.getsource(cs.phase_kernels)


def test_chip_smoke_holds_k1_at_every_lane_count_the_paths_give_it():
    """Every permutation a transcript makes goes through `cuda_keccak.f1600`
    (the transcript calls it through the module), where the full run's
    record notes its lane count; the kernels phase holds K1 at each count
    and at the verifiers' 1024 and 16384. Recorded here through the plain
    version on the CPU."""
    import inspect

    from bppp_tpu_torch.transcript.device import Transcript

    cs = _chip_smoke()
    wrapper = cs.cuda_keccak.f1600
    log = cs.new_shape_log()
    with cs.recording_shapes(log, "verify"):
        t = Transcript(b"lanes", batch=(3, 2), device="cpu")
        t.challenge_scalar(b"c")
    assert cs.cuda_keccak.f1600 is wrapper
    assert log["f1600"] == {6}
    lanes = cs.keccak_lanes_plan(log)
    assert 6 in lanes and set(cs.KECCAK_LANES) <= set(lanes) == {6, cs.BATCH, cs.BIG_BATCH}
    src = inspect.getsource(cs.phase_kernels)
    assert "keccak_lanes_plan(shapes)" in src and "check_keccak(gen, dev, 77)" in src
    assert cs.MAIN_ROW["f1600"] == f"f1600[B={cs.BATCH}]"


def test_chip_smoke_holds_k5a_at_every_lane_count_the_paths_give_it():
    """Every complete add the paths or the table builds make goes through
    `cuda_curve.pt_add`, where the full run's record notes its lane count
    (operands broadcast: the table build's (NW, F, 2^k) entries against
    (NW, F, 1) doubles); the kernels phase holds K5a at each count, and its
    fixed count is one where the plan takes 2 threads per lane. Recorded
    here through the plain version on the CPU."""
    import inspect

    cs = _chip_smoke()
    wrapper = cs.cuda_curve.pt_add
    ident = lambda shape: cs.dc.identity(shape, device="cpu")
    log = cs.new_shape_log()
    with cs.recording_shapes(log, "verify"):
        out = cs.dc.pt_add(ident((2, 3, 2)), ident((2, 3, 1)))
        cs.dc.pt_add(ident((5,)), ident((1,)))
    assert cs.cuda_curve.pt_add is wrapper
    assert tuple(out.x.shape) == (16, 2, 3, 2) and bool(cs.dc.pt_is_identity(out).all())
    assert log["pt_add"] == {12, 5}
    lanes = cs.add_lanes_plan(log)
    assert {12, 5} <= set(lanes) and set(cs.ADD_LANES) <= set(lanes)
    assert all(cs.cuda_curve.pt_add_plan(B)[0] == 2 for B in cs.ADD_LANES)
    assert "add_lanes_plan(shapes)" in inspect.getsource(cs.phase_kernels)


def test_chip_smoke_gives_every_prover_tuple_a_row_index_row(monkeypatch):
    """Every position tuple handed to `msm_fixed_positions` reaches K3 as a
    row view of the one table (no copied rows), the full run's record keeps
    each view, and the kernels phase holds K3 at every recorded view: so
    each tuple the paths use has a row-index row. Recorded here through a
    stand-in for the kernel's wrapper, over a table of zeros."""
    import inspect

    import torch

    from bppp_tpu_torch.ops import cuda_fixed_base as cfb
    from bppp_tpu_torch.ops import fixed_base as fb

    cs = _chip_smoke()
    words = torch.zeros((cfb.n_windows(2), 49, 4, 16), dtype=torch.int32)
    tab = cfb.Tables(words, 2, {})
    zeros = lambda t, s: tuple(
        torch.zeros((16, s.shape[2]), dtype=torch.int64) for _ in range(3))
    monkeypatch.setattr(cs.cuda_fixed_base, "fixed_msm", zeros)
    tuples = [cs.round0_r_positions(), (0, 1), (12, 3, 7)]
    log = cs.new_shape_log()
    with cs.recording_shapes(log, "prove"):
        for pos in tuples + tuples:  # a tuple met again is one view, one row
            fb.msm_fixed_positions(tab, None, pos, torch.zeros((16, len(pos), 2),
                                                               dtype=torch.int64))
    _, _, k3 = cs.shape_plan(log)
    assert [t.rows.tolist() for t, _ in k3] == [list(p) for p in tuples]
    assert all(t.words is words and w == "prove" for t, w in k3)
    src = inspect.getsource(cs.phase_kernels)
    assert "for i, (tab, where) in enumerate(k3_tables):" in src
    assert 'tag += " rows"' in inspect.getsource(cs.check_fixed)


@pytest.mark.parametrize("F", [33, 49, 65, 129])
def test_chip_smoke_holds_the_table_build_at_every_shape_a_build_gives(monkeypatch, F):
    """The fixtures' table builds are timed through `timing_table_builds`,
    which also notes what each build gives the doubling chain (F
    generators, 255 doubles) and the affine step (32 F rows of 256
    entries), here through stand-ins for the build and the two wrappers;
    the kernels phase adds a row for each beside the fixed u64 / WNLA-64
    shapes."""
    import inspect

    import torch

    cs = _chip_smoke()
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(cs.cuda_curve, "pt_double_chain", lambda *a: calls.append("chain"))
    monkeypatch.setattr(cs.cuda_curve, "affine_rows", lambda *a: calls.append("affine"))

    def build_tables(points, w_bits):
        cs.cuda_curve.pt_double_chain(points.x, points.y, points.z, cs.CHAIN_N)
        ents = torch.zeros((16, 32 * points.x.shape[1], 1 << w_bits), dtype=torch.int64)
        cs.cuda_curve.affine_rows(ents, ents, ents)

    from bppp_tpu_torch.ops import fixed_base
    from bppp_tpu_torch.protocol import u64 as pu64

    # every module that `timing_table_builds` rebinds, so each gets its own back
    for mod in (cs.cuda_fixed_base, fixed_base, pu64):
        monkeypatch.setattr(mod, "build_tables", build_tables)
    stand_ins = (cs.cuda_curve.pt_double_chain, cs.cuda_curve.affine_rows,
                 cs.cuda_fixed_base.build_tables)
    builds = []
    with cs.timing_table_builds(builds):
        pts = cs.dc.identity((F,), device="cpu")
        cs.cuda_fixed_base.build_tables(pts, 8)
    assert calls == ["chain", "affine"]
    assert (cs.cuda_curve.pt_double_chain, cs.cuda_curve.affine_rows,
            cs.cuda_fixed_base.build_tables) == stand_ins
    assert [(b["points"], b["chain"], b["affine"]) for b in builds] == [
        (F, [[F, cs.CHAIN_N]], [[32 * F, 256]])]
    log = cs.new_shape_log()
    log["table_builds"] = builds
    chains, affine = cs.table_build_plan(log)
    assert (F, cs.CHAIN_N) in chains and {(f, cs.CHAIN_N) for f in cs.CHAIN_LANES} <= set(chains)
    assert (32 * F, 256) in affine and set(cs.AFFINE_SHAPES) <= set(affine)
    assert "table_build_plan(shapes)" in inspect.getsource(cs.phase_kernels)
    assert 'shapes["table_builds"] = ctx["table_builds"] + wnla_builds' in inspect.getsource(cs.main)
