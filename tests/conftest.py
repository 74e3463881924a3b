"""Test configuration: run all tests on CPU with 8 virtual devices so the
multi-chip sharding path is exercised without a TPU pod (SURVEY.md §4).

Suite-level invocations (a directory target, e.g. `pytest tests/ -x -q`)
run each test FILE in its own subprocess: long single-process runs of the
full suite segfault inside jaxlib after ~a dozen large AOT-imported
programs have been loaded (heap corruption — crash site is the persistent
-cache zstd read in whichever compile comes next; every file passes in
isolation). Per-file processes bound the accumulation deterministically.
Opt out with BPPP_SUITE_ISOLATE=0. Single-file / node-id invocations are
unaffected."""
import os
import subprocess
import sys

# Force CPU: the ambient environment may pin JAX_PLATFORMS to a real
# accelerator; tests must run on the 8-virtual-device CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# Interpret-mode kernel tests size their inputs from TILE = BPPP_SUB*128;
# the hardware default (8, picked by device-time A/B) would double every
# CPU test's lane count for no semantic coverage — kernel math is
# _SUB-independent. Pin 4 unless the caller overrides.
os.environ.setdefault("BPPP_SUB", "4")
# W=8 keeps interpret-mode table builds small (NE-2 sequential adds per
# window); the W=11 production default is covered by an explicit
# parametrized case and by tools/tpu_kernel_check.py on hardware.
os.environ.setdefault("BPPP_FBW", "8")

import jax  # noqa: E402

# Belt and braces: if a pytest plugin imported jax before this conftest
# ran, the env var above came too late — override via config (works any
# time before backend initialization).
jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: protocol graphs are large; recompiling them
# on every pytest invocation would dominate suite time.
jax.config.update("jax_compilation_cache_dir", os.path.join(os.path.dirname(__file__), "..", ".jax_cache"))
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def _warm_state() -> tuple[str, int]:
    """(cpu source hash, number of AOT cache entries at that hash). The
    AOT filename embeds the source hash (utils/aot.py), so staleness is a
    directory listing, not an hour of silent re-tracing."""
    import glob

    from bppp_tpu.utils.aot import _DEFAULT_DIR, _src_hash

    src = _src_hash("cpu")
    n = len(glob.glob(os.path.join(_DEFAULT_DIR, f"*-cpu-{src}-*.jaxexport")))
    return src, n


def pytest_cmdline_main(config):
    """Take over directory-level runs and re-exec one pytest per file.

    Returning a non-None exit code preempts pytest's default session
    (firstresult hook; initial conftests are consulted before builtins).
    """
    if os.environ.get("BPPP_SUITE_ISOLATE", "1") == "0":
        return None
    if os.environ.get("_BPPP_SUITE_CHILD") == "1":
        return None
    # Cold-cache runs of the full suite cost an hour+ of tracing on this
    # 1-core host. Say so UP FRONT (and fail if the round-end procedure
    # demanded a warm cache) instead of silently costing the hour.
    src, warm_n = _warm_state()
    print(f"[suite] cpu src hash {src}: {warm_n} warm AOT entries", flush=True)
    if warm_n == 0 and os.environ.get("BPPP_REQUIRE_WARM"):
        print(
            "[suite] BPPP_REQUIRE_WARM is set and the AOT cache has no "
            "entries at this source state — run the suite once (or the "
            "round-end warm procedure) before the certification run.",
            flush=True,
        )
        return 3
    args = list(config.invocation_params.args)
    targets = [a for a in args if not a.startswith("-")]
    here = os.path.dirname(os.path.abspath(__file__))
    # Only directory targets (or no target from the repo root) get the
    # per-file treatment; explicit files/node-ids keep default behavior.
    if targets and not all(os.path.isdir(t) for t in targets):
        return None
    dirs = [os.path.abspath(t) for t in targets] or [here]
    files = sorted(
        os.path.join(d, f)
        for d in dirs
        for f in os.listdir(d)
        if f.startswith("test_") and f.endswith(".py")
    )
    if not files:
        return None
    flags = [a for a in args if a.startswith("-")]
    stop_on_fail = "-x" in flags or "--exitfirst" in flags
    env = dict(os.environ, _BPPP_SUITE_CHILD="1")
    worst = 0
    for f in files:
        rel = os.path.relpath(f)
        print(f"[suite] {rel}", flush=True)
        rc = subprocess.call(
            [sys.executable, "-m", "pytest", *flags, f], env=env
        )
        if rc == 5:  # no tests collected in this file (e.g. all skipped)
            rc = 0
        if rc != 0:
            worst = worst or rc
            if stop_on_fail:
                break
    return worst


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: takes many minutes on a CPU (a cold XLA compile of a whole "
        "protocol program); deselected by -m 'not slow'",
    )
