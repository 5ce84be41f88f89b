"""chip_smoke.py refuses to run without a GPU or without the repository,
and the compile-cache helper honours JAX_COMPILATION_CACHE_DIR."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env=None, timeout=120):
    e = dict(os.environ)
    e.update(env or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=timeout)


def test_chip_smoke_refuses_cpu_backend():
    r = _run([os.path.join(REPO, "chip_smoke.py")], REPO,
             {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_refuses_without_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run([str(tmp_path / "chip_smoke.py")], str(tmp_path),
             {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert "not beside" in r.stderr
    assert '"ok"' not in r.stdout


_PROBE = ("import jax; from dgnn.utils import enable_compile_cache; "
          "d = enable_compile_cache(); "
          "print(d); print(jax.config.jax_compilation_cache_dir)")


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(tmp_path, env_set):
    env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "jaxcache")
    else:
        env["JAX_COMPILATION_CACHE_DIR"] = ""
    r = _run(["-c", _PROBE], str(tmp_path), env)
    assert r.returncode == 0, r.stderr
    returned, configured = r.stdout.split()
    want = (str(tmp_path / "jaxcache") if env_set else
            os.path.join(REPO, ".bench_cache", "xla_cache"))
    assert returned == configured == want
    if not env_set:
        assert os.path.isdir(want)


@pytest.mark.parametrize("phase", ["gat_reddit", "monet_dgcnn", "four"])
def test_chip_smoke_phase_on_cpu(phase):
    """chip_smoke.py's phases (b)-(d) run on the CPU at a tiny scale (the
    4-device phase on the virtual mesh) and every check passes."""
    import chip_smoke

    chk = chip_smoke.Check()
    if phase == "gat_reddit":
        chip_smoke.phase_gat_reddit(chk, scale=0.0004)
    elif phase == "monet_dgcnn":
        chip_smoke.phase_monet_dgcnn(chk, bs=4, pts=128)
    else:
        chip_smoke.phase_four(chk, scale=0.0004)
    assert not chk.failed
