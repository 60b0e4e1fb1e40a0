"""The GPU scripts' refusal to run or time anything without a GPU, the
package's former import name, and where the persistent compilation cache
goes."""

import json
import os
import pkgutil
import shutil
import subprocess
import sys

import jax
import pytest

from fluid_simulation.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "script_alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """On CPU JAX (and in a directory holding only the script, where the
    package cannot be imported) chip_smoke.py exits non-zero and prints no
    result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "script_alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def _cpu_run(argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable] + argv, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("argv", [
    ["bench.py"],
    ["tools/kernel_ab.py", "--phases", "sweep", "--grids", "24x12x10"],
    ["tools/kernel_ab.py", "--phases", "check", "--grids", "24x12x10"],
])
def test_timing_scripts_refuse_without_gpu(argv):
    """A timing taken on the CPU must never be written under a kernel's
    name: without a GPU these scripts exit non-zero and print no timing."""
    r = _cpu_run(argv)
    assert r.returncode != 0
    for key in ("ms_per_step", "us_per_sweep", "s_with_compile",
                "rel_max_diff"):
        assert key not in r.stdout


def test_kernel_ab_interpret_rehearsal():
    """--interpret runs the untimed phases with the kernel in interpret mode
    (bitwise equal to the jnp solve) and emits no timing; it refuses the
    timed phases."""
    r = _cpu_run(["tools/kernel_ab.py", "--phases", "hlo,check",
                  "--grids", "24x12x10", "--interpret"])
    assert r.returncode == 0, r.stderr[-2000:]
    recs = [json.loads(line) for line in r.stdout.splitlines()
            if line.startswith("{")]
    checks = [x for x in recs if x["phase"] == "check"]
    assert len(checks) == 12 and all(x["rel_max_diff"] == 0.0
                                     for x in checks)
    assert any(x["phase"] == "hlo" and x["fusions"] > 0 for x in recs)
    timing = {"s_with_compile", "done_s", "us_per_sweep", "ms_per_step"}
    assert not any(timing & set(x) for x in recs)
    r = _cpu_run(["tools/kernel_ab.py", "--phases", "check,sweep",
                  "--interpret"])
    assert r.returncode != 0 and "untimed" in r.stderr


def test_former_package_name_is_an_alias():
    """The package's former name still imports: it warns, and it and its
    submodules are the very module objects of fluid_simulation."""
    olds = [m.name for m in pkgutil.iter_modules([ROOT])
            if m.ispkg and m.name.startswith("fluid_simulation_")]
    assert len(olds) == 1
    old = olds[0]
    code = (
        "import sys, warnings\n"
        "warnings.simplefilter('error', DeprecationWarning)\n"
        f"try:\n    import {old}\nexcept DeprecationWarning:\n    pass\n"
        "else:\n    sys.exit('no DeprecationWarning')\n"
        "warnings.simplefilter('ignore')\n"
        f"import {old}, {old}.cli\n"
        f"from {old}.models.windtunnel import WindTunnel\n"
        "import fluid_simulation, fluid_simulation.cli\n"
        f"assert {old} is fluid_simulation\n"
        f"assert {old}.cli is fluid_simulation.cli\n"
        "assert fluid_simulation.cli.__spec__.name == 'fluid_simulation.cli'\n"
        "assert WindTunnel is fluid_simulation.WindTunnel\n")
    r = _cpu_run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set; without it
    the cache is <checkout>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv(cache.ENV_VAR, raising=False)
            assert cache.enable_compile_cache() == os.path.join(
                ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == os.path.join(
                ROOT, ".jax_cache")
        else:
            path = str(tmp_path / env_dir)
            monkeypatch.setenv(cache.ENV_VAR, path)
            jax.config.update("jax_compilation_cache_dir", path)
            assert cache.enable_compile_cache() == path
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
